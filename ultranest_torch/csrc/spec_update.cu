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
// counts are int64 sums (exact in any order); the float sum of wbuf is
// left to the caller, so that its order stays torch's.
//
// The chord is chord.cuh's (shared with K6), as the plain version's
// _cube_intersection.
//
// Bound on an H100: bytes, but far below a launch. A walker reads its
// D likelihoods, ts and tin, and its u, v (and, renewed, a row of
// dirbank); it writes u, v and a few scalars: at P 4096, D 8, d 50
// about 2.5 MB, under 1 us at 3.35 TB/s, which is less than an empty
// kernel takes on the card. So what sets its time is the latency of
// its chain of dependent reads, and the launch. Design: one warp a
// walker, its lanes over the chain (32 candidates at a time, a ballot
// finds the first hit) and over the d coordinates. The reads that do
// not wait for the first hit are issued before the ballot: the
// candidates' Lp, ts and tin, the walker's flag, step, bracket and
// shrunk bracket, and, for a walker not done, its u and v and the one
// row of dirbank a renewal can take (step + 1's), up to NK coordinates
// a lane in registers (the rest, above d 128, read after the ballot);
// the hit's t and L come from the lane that read them by a shuffle. The
// chord's max and min fold across the warp with shuffles where the
// walker renews. The counts are summed in shared memory, one 64-bit
// atomic a counter a block: atomics on the same three addresses from
// every walker serialise in L2.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "chord.cuh"

namespace {

using chord_core::chord;
using chord_core::chord_warp_fold;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

template <int NK>
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
  __shared__ unsigned counts[3];   // billed, useful, accepted
  if (threadIdx.x < 3) counts[threadIdx.x] = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) *it += 1;
  const int lane = threadIdx.x & 31;
  const int p = static_cast<int>((blockIdx.x * kThreads + threadIdx.x) / 32);
  const bool live = p < P;   // a warp past P only joins the barriers

  // every read that does not wait for the first hit
  const float Lmin = *Lmin_p;
  bool active = false;
  int64_t step0 = 0;
  float tl0 = 0.0f, tr0 = 0.0f, tlc0 = 0.0f, trc0 = 0.0f;
  if (live) {
    active = done[p] == 0;
    step0 = step[p];
    if (lane == 0) {
      tl0 = tl[p];
      tr0 = tr[p];
      tlc0 = tlc[p];
      trc0 = trc[p];
    }
  }
  const int64_t row = static_cast<int64_t>(p) * D;
  const int64_t off = static_cast<int64_t>(p) * d;
  // the one direction a renewal can take: step + 1's
  int64_t s = step0 + 1;
  s = s < nsteps ? s : nsteps - 1;
  s = s < 0 ? 0 : s;
  const float* vn = dirbank + (s * P + p) * static_cast<int64_t>(d);
  float uk[NK], vk[NK], wk[NK];
#pragma unroll
  for (int i = 0; i < NK; ++i) {
    const int k = lane + i * 32;
    uk[i] = vk[i] = wk[i] = 0.0f;
    if (active && k < d) {
      uk[i] = u[off + k];
      vk[i] = v[off + k];
      wk[i] = vn[k];
    }
  }

  // the first hit in chain order, 32 candidates at a time; billed rows,
  // and those a sequential sampler would have evaluated (j <= jstar, or
  // all while no candidate hit)
  int jstar = D;
  float tstar = 0.0f, Lstar = 0.0f;
  int nbilled = 0, nuseful = 0;
  for (int j0 = 0; j0 < D; j0 += 32) {
    const int j = j0 + lane;
    const bool in = live && j < D;
    float Lj = 0.0f, tj = 0.0f;
    bool bill = false;
    if (in) {
      Lj = Lp[row + j];
      tj = ts[row + j];
      bill = active && (tin == nullptr || tin[row + j] != 0);
    }
    const unsigned hb = __ballot_sync(kFull, in && Lj > Lmin);
    const int first = hb ? __ffs(hb) - 1 : 0;
    const float tf = __shfl_sync(kFull, tj, first);
    const float Lf = __shfl_sync(kFull, Lj, first);
    if (hb && jstar == D) {
      jstar = j0 + first;
      tstar = tf;
      Lstar = Lf;
    }
    nbilled += __popc(__ballot_sync(kFull, bill));
    nuseful += __popc(__ballot_sync(kFull, bill && j <= jstar));
  }

  const bool anyhit = jstar < D && active;
  const int64_t step_new = step0 + (anyhit ? 1 : 0);
  const bool done_new = !active || (anyhit && step_new >= nsteps);
  const bool renew = anyhit && !done_new;
  float lo = -CUDART_INF_F, hi = CUDART_INF_F;
  if (anyhit) {
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      const int k = lane + i * 32;
      if (k < d) {
        const float un = __fadd_rn(uk[i], __fmul_rn(tstar, vk[i]));
        u[off + k] = un;
        if (renew) {
          v[off + k] = wk[i];
          chord(un, wk[i], lo, hi);
        }
      }
    }
    for (int k = lane + NK * 32; k < d; k += 32) {
      const float un = __fadd_rn(u[off + k], __fmul_rn(tstar, v[off + k]));
      u[off + k] = un;
      if (renew) {
        const float w = vn[k];
        v[off + k] = w;
        chord(un, w, lo, hi);
      }
    }
  }
  // renew is the same on every lane of the walker's warp
  if (renew) chord_warp_fold(lo, hi);
  __syncthreads();   // the block's counts are zeroed
  if (live && lane == 0) {
    wbuf[p] = anyhit ? __fsub_rn(tr0, tl0) : 0.0f;
    if (anyhit) {
      L[p] = Lstar;
      step[p] = step_new;
    }
    done[p] = done_new ? 1 : 0;
    if (renew) {
      tl[p] = lo;
      tr[p] = hi;
    } else if (!anyhit && !done_new) {
      tl[p] = tlc0;
      tr[p] = trc0;
    }
    if (nbilled) atomicAdd(&counts[0], static_cast<unsigned>(nbilled));
    if (nuseful) atomicAdd(&counts[1], static_cast<unsigned>(nuseful));
    if (anyhit) atomicAdd(&counts[2], 1u);
  }
  __syncthreads();
  if (threadIdx.x < 3 && counts[threadIdx.x]) {
    int64_t* dst = threadIdx.x == 0 ? ncr : threadIdx.x == 1 ? nur : nw;
    atomicAdd(reinterpret_cast<unsigned long long*>(dst),
              static_cast<unsigned long long>(counts[threadIdx.x]));
  }
}

template <int NK>
int launch(const float* Lp, const uint8_t* tin, const float* ts,
           const float* tlc, const float* trc, const float* Lmin,
           const float* dirbank, int nsteps, int P, int D, int d, float* u,
           float* L, float* v, float* tl, float* tr, int64_t* step,
           uint8_t* done, float* wbuf, int64_t* ncr, int64_t* nur,
           int64_t* nw, int64_t* it, cudaStream_t stream) {
  const int64_t threads = static_cast<int64_t>(P) * 32;
  const int blocks = P > 0 ? static_cast<int>((threads + kThreads - 1)
                                              / kThreads) : 1;
  spec_update_kernel<NK><<<blocks, kThreads, 0, stream>>>(
      Lp, tin, ts, tlc, trc, Lmin, dirbank, nsteps, P, D, d, u, L, v, tl, tr,
      step, done, wbuf, ncr, nur, nw, it);
  return static_cast<int>(cudaGetLastError());
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UN_SPEC_UPDATE(NK)                                                  \
  return launch<NK>(Lp, tin, ts, tlc, trc, Lmin, dirbank, nsteps, P, D, d, \
                    u, L, v, tl, tr, step, done, wbuf, ncr, nur, nw, it, s)
  if (d <= 32) UN_SPEC_UPDATE(1);
  if (d <= 64) UN_SPEC_UPDATE(2);
  UN_SPEC_UPDATE(4);
#undef UN_SPEC_UPDATE
}
