// K5: the update half of one round of the speculative-shrink walk.
//
// Replaces the second half of the lax.while_loop body of the JAX
// package's spec walk, ultranest_tpu/popfused.py:587-640 (_build_spec;
// an XLA loop, not a Pallas kernel). Given the likelihoods Lp (P*D,) of
// the rows K4 proposed and, where the p-space filter ran, the rows it
// let through (tin), for each walker p:
//   active = !done;  billed_j = active && tin_j
//   hit_j = Lp_j > Lmin;  jstar = first j with a hit, else D, then
//   clamped to D-1;  kneed = jstar + 1 where some j hit, else D
//   ncr += #billed;  nur += #(billed_j && j < kneed)
//   anyhit = (some j hit) && active
//   if anyhit: u += ts[jstar] * v;  L = Lp[jstar];  step += 1
//   wbuf[p] = anyhit ? tr - tl : 0;  nw += anyhit
//   done |= anyhit && step >= nsteps
//   not accepted and not done: tl, tr = tlc, trc (the shrunk bracket)
//   accepted and not done: v = dirbank[min(step, nsteps-1), p] and
//     tl, tr = the chord of u + t v through the unit cube
// The state (u, L, v, tl, tr, step, done) is updated in place: each
// walker owns its row. The round counter it advances by one. The three
// counts are int64 sums (atomics, exact in any order); the float sum of
// wbuf is left to the caller, so that its order stays torch's.
//
// The chord, as the plain version's _cube_intersection: per axis with
// v != 0, a = (0 - u) / v and b = (1 - u) / v, each operation rounded
// on its own (so a zero u gives the signed zero of 0 / v); an axis with
// v == 0 (either zero) gives a = -inf, b = +inf; tl = max over axes of
// min(a, b), tr = min over axes of max(a, b), NaN propagating as
// torch.minimum, torch.maximum, amax and amin propagate it. The one
// thing left to order: where the extreme is a zero reached with both
// signs on two axes (a walker exactly on a cube corner), the two folds
// may keep either sign, as torch's reductions may.
//
// Bound on an H100: bytes. A walker reads its D likelihoods, ts and
// tin, and its u, v (and, renewed, a row of dirbank); it writes u, v
// and a few scalars: at P 4096, D 8, d 50 about 2.5 MB, under 1 us at
// 3.35 TB/s. Design: one warp a walker, its lanes over the chain (32
// candidates at a time, a ballot finds the first hit) and then over
// the d coordinates, so that the row reads and writes are coalesced;
// the chord's max and min fold across the lanes with shuffles.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// torch.maximum / torch.minimum: a NaN operand wins; a tie keeps a
__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b > a ? b : a;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

__global__ void __launch_bounds__(kThreads)
spec_update_kernel(const float* __restrict__ Lp,
                   const uint8_t* __restrict__ tin,
                   const float* __restrict__ ts, const float* __restrict__ tlc,
                   const float* __restrict__ trc,
                   const float* __restrict__ Lmin_p,
                   const float* __restrict__ dirbank, int nsteps, int P, int D,
                   int d, float* __restrict__ u, float* __restrict__ L,
                   float* __restrict__ v, float* __restrict__ tl,
                   float* __restrict__ tr, int64_t* __restrict__ step,
                   uint8_t* __restrict__ done, float* __restrict__ wbuf,
                   int64_t* __restrict__ ncr, int64_t* __restrict__ nur,
                   int64_t* __restrict__ nw, int64_t* __restrict__ it) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *it += 1;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= P) return;   // the whole warp: p is the warp's
  const float Lmin = *Lmin_p;
  const bool active = done[p] == 0;
  const int64_t row = static_cast<int64_t>(p) * D;

  // the first hit in chain order
  int jstar = D;
  for (int j0 = 0; j0 < D && jstar == D; j0 += 32) {
    const int j = j0 + lane;
    const bool hit = j < D && Lp[row + j] > Lmin;
    const unsigned hb = __ballot_sync(kFull, hit);
    if (hb) jstar = j0 + __ffs(hb) - 1;
  }
  const bool anyhit0 = jstar < D;
  const int kneed = anyhit0 ? jstar + 1 : D;
  if (!anyhit0) jstar = D - 1;
  // billed rows, and those a sequential sampler would have evaluated
  int nbilled = 0, nuseful = 0;
  for (int j0 = 0; j0 < D; j0 += 32) {
    const int j = j0 + lane;
    const bool bill = j < D && active && (tin == nullptr || tin[row + j] != 0);
    nbilled += __popc(__ballot_sync(kFull, bill));
    nuseful += __popc(__ballot_sync(kFull, bill && j < kneed));
  }

  const bool anyhit = anyhit0 && active;
  const int64_t step_new = step[p] + (anyhit ? 1 : 0);
  const bool done_new = !active || (anyhit && step_new >= nsteps);
  const bool renew = anyhit && !done_new;
  const float tstar = ts[row + jstar];
  const int64_t off = static_cast<int64_t>(p) * d;
  float lo = -CUDART_INF_F, hi = CUDART_INF_F;
  if (anyhit) {
    const int64_t s = step_new < nsteps ? step_new : nsteps - 1;
    const float* vn = dirbank + (s * P + p) * static_cast<int64_t>(d);
    for (int k = lane; k < d; k += 32) {
      const float uk = __fadd_rn(u[off + k], __fmul_rn(tstar, v[off + k]));
      u[off + k] = uk;
      if (renew) {
        const float vk = vn[k];
        v[off + k] = vk;
        float a = -CUDART_INF_F, b = CUDART_INF_F;
        if (vk != 0.0f) {
          a = __fdiv_rn(__fsub_rn(0.0f, uk), vk);
          b = __fdiv_rn(__fsub_rn(1.0f, uk), vk);
        }
        lo = max_nan(lo, min_nan(a, b));
        hi = min_nan(hi, max_nan(a, b));
      }
    }
  }
  if (renew) {
    for (int o = 16; o > 0; o >>= 1) {
      lo = max_nan(lo, __shfl_down_sync(kFull, lo, o));
      hi = min_nan(hi, __shfl_down_sync(kFull, hi, o));
    }
  }
  if (lane == 0) {
    const float tl0 = tl[p], tr0 = tr[p];
    wbuf[p] = anyhit ? __fsub_rn(tr0, tl0) : 0.0f;
    if (anyhit) {
      L[p] = Lp[row + jstar];
      step[p] = step_new;
    }
    done[p] = done_new ? 1 : 0;
    if (renew) {
      tl[p] = lo;
      tr[p] = hi;
    } else if (!anyhit && !done_new) {
      tl[p] = tlc[p];
      tr[p] = trc[p];
    }
    if (nbilled) atomicAdd(reinterpret_cast<unsigned long long*>(ncr),
                           static_cast<unsigned long long>(nbilled));
    if (nuseful) atomicAdd(reinterpret_cast<unsigned long long*>(nur),
                           static_cast<unsigned long long>(nuseful));
    if (anyhit) atomicAdd(reinterpret_cast<unsigned long long*>(nw), 1ull);
  }
}

}  // namespace

// tin: nullptr where every row is billed
extern "C" int un_spec_update(const float* Lp, const uint8_t* tin,
                              const float* ts, const float* tlc,
                              const float* trc, const float* Lmin,
                              const float* dirbank, int nsteps, int P, int D,
                              int d, float* u, float* L, float* v, float* tl,
                              float* tr, int64_t* step, uint8_t* done,
                              float* wbuf, int64_t* ncr, int64_t* nur,
                              int64_t* nw, int64_t* it, void* stream) {
  const int blocks = P > 0 ? (P + kWarps - 1) / kWarps : 1;
  spec_update_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      Lp, tin, ts, tlc, trc, Lmin, dirbank, nsteps, P, D, d, u, L, v, tl, tr,
      step, done, wbuf, ncr, nur, nw, it);
  return static_cast<int>(cudaGetLastError());
}
