// K6: the update half of one shrink iteration of the sync walk, and the
// step boundary around it.
//
// Replaces the second half of the lax.while_loop body of the JAX
// package's sync engine, ultranest_tpu/popfused.py:849-863 (_build; an
// XLA loop, not a Pallas kernel), and the step boundary around that
// loop (:842, :865-870). A round is one shrink iteration of every
// walker: K4 (spec_propose.cu at D = 1) proposes t = tlc + xi (trc -
// tlc) and the row u + t v from bank row `row`, the likelihood
// evaluates the rows, and K6, given the likelihoods Lp (P,), the rows
// the p-space filter let through (tin, or none) and K4's t, tlc, trc,
// updates each walker p:
//   acc = Lp > Lmin && !done
//   acc: un = u + t v (K4's row, each operation rounded on its own, as
//        K4 rounds it), Ln = Lp, done = 1
//   !acc && !done: tl, tr = tlc, trc (the shrunk bracket)
// and the counters: nc += P, or the rows tin let through (every row,
// done walkers' too, as the JAX package bills them); it += 1. Where
// every walker is done or it reaches max_it, step s ends in the same
// launch:
//   accs[s] = #done / P, one rounded division
//   widths[s] = (w[(P-1)/2] + w[P/2]) * 0.5 over the sorted final
//     brackets w = tr - tl (NaN last, as torch.sort sorts)
//   s += 1, it = 0, and while s < nsteps: u = un, v = dirbank[s], tl,
//     tr = the chord of u + t v through the unit cube (chord.cuh, K5's
//     own), done = 0
// K6 keeps the bank row K4 reads, row = s * max_it + it; past the last
// step it stays at the bank's last row. flag = s >= nsteps. Once s ==
// nsteps a round changes nothing and bills nothing, so rounds queued
// past the end are exact no-ops.
//
// Bound on an H100: bytes, far below a launch. A round reads each
// walker's likelihood, t, shrunk bracket, flag and filter row (about 17
// bytes) and copies an accepted walker's row; a step boundary reads the
// widths and a row of directions and writes u, v and the chord: at P
// 128, d 8 about 6 KB, some nanoseconds at 3.35 TB/s. What sets its time
// is the two launches and the boundary's chain of passes.
//
// Design: two kernels, one launch call. (1) One warp a walker, as K5:
// a rejecting walker's lane 0 copies the shrunk bracket, an accepting
// walker's lanes copy its row over the d coordinates. (2) One CTA of
// 512 threads: the done count and the billed rows (strided over the
// walkers, summed by shuffles and shared memory), the counters and,
// where the step ends, the median and the next step's directions and
// chords, a warp a walker. The boundary needs the whole population after
// (1), so it is a second kernel on the stream, never a host round trip;
// one CTA serves any P, its loops striding over the walkers. The median
// is two order statistics of the widths' 32-bit keys (the float's bits
// mapped so that unsigned order is the floats' order, -0 below +0, NaN
// above +inf): the lower one by radix selection, four passes of 8 bits
// with a 256-bin histogram in shared memory; the upper one is the same
// key where it repeats past the lower rank, else the least key above
// it. Exact selection gives torch.sort's values, so the median is the
// plain version's bits (the one tie left free: a -0 and a +0 width at
// the median rank, which torch.sort may order either way).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "chord.cuh"

namespace {

using chord_core::chord;
using chord_core::chord_warp_fold;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWalkerThreads = 256;
constexpr int kStepThreads = 512;

__global__ void __launch_bounds__(kWalkerThreads)
sync_walker_kernel(const float* __restrict__ Lp, const float* __restrict__ ts,
                   const float* __restrict__ tlc,
                   const float* __restrict__ trc,
                   const float* __restrict__ Lmin_p,
                   const int64_t* __restrict__ s_p, int nsteps, int P, int d,
                   const float* __restrict__ u, const float* __restrict__ v,
                   float* __restrict__ tl, float* __restrict__ tr,
                   float* __restrict__ un, float* __restrict__ Ln,
                   uint8_t* __restrict__ done) {
  const int lane = threadIdx.x & 31;
  const int64_t p = (static_cast<int64_t>(blockIdx.x) * kWalkerThreads
                     + threadIdx.x) / 32;
  if (p >= P || *s_p >= nsteps || done[p]) return;
  const float L = Lp[p];
  if (L > *Lmin_p) {
    const float t = ts[p];
    const int64_t off = p * d;
    for (int k = lane; k < d; k += 32)
      un[off + k] = __fadd_rn(u[off + k], __fmul_rn(t, v[off + k]));
    if (lane == 0) {
      Ln[p] = L;
      done[p] = 1;
    }
  } else if (lane == 0) {
    tl[p] = tlc[p];
    tr[p] = trc[p];
  }
}

// a float's 32-bit key: unsigned order is the floats' order (-0 below
// +0), every NaN above +inf
__device__ __forceinline__ unsigned width_key(float w) {
  if (w != w) return 0xffffffffu;
  const unsigned b = __float_as_uint(w);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_width(unsigned k) {
  if (k == 0xffffffffu) return CUDART_NAN_F;
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// the sum (or min) of one value a thread over the block; every thread
// gets it. red: 32 words of shared memory, free on entry.
__device__ unsigned block_sum(unsigned x, unsigned* red) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  x = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0u;
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ unsigned block_min(unsigned x, unsigned* red) {
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(kFull, x, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  x = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0xffffffffu;
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// the key of rank k (0-based) among the P widths tr - tl: four passes
// of 8 bits from the top, each counting the keys that share the bits
// chosen so far
__device__ unsigned select_key(const float* __restrict__ tl,
                               const float* __restrict__ tr, int P,
                               unsigned k, unsigned* hist, unsigned* sel) {
  unsigned prefix = 0, mask = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = threadIdx.x; b < 256; b += blockDim.x) hist[b] = 0;
    __syncthreads();
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      const unsigned key = width_key(__fsub_rn(tr[p], tl[p]));
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned b = 0;
      while (b < 255 && k >= hist[b]) k -= hist[b++];
      sel[0] = prefix | (b << shift);
      sel[1] = k;
    }
    __syncthreads();
    prefix = sel[0];
    k = sel[1];
    mask |= 255u << shift;
  }
  return prefix;
}

__global__ void __launch_bounds__(kStepThreads)
sync_step_kernel(const uint8_t* __restrict__ tin,
                 const float* __restrict__ dirbank, int nsteps, int max_it,
                 int P, int d, float* __restrict__ u, float* __restrict__ v,
                 float* __restrict__ tl, float* __restrict__ tr,
                 const float* __restrict__ un, uint8_t* __restrict__ done,
                 int64_t* __restrict__ nc, int64_t* __restrict__ s_p,
                 int64_t* __restrict__ it_p, int64_t* __restrict__ row_p,
                 uint8_t* __restrict__ flag, float* __restrict__ accs,
                 float* __restrict__ widths) {
  __shared__ unsigned red[32];
  __shared__ unsigned hist[256];
  __shared__ unsigned sel[2];
  // every thread reads the counters before thread 0 writes them (the
  // block's barriers below come first)
  const int64_t s = *s_p;
  if (s >= nsteps) return;
  const int64_t it = *it_p + 1;
  unsigned ndone = 0, nbill = 0;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    ndone += done[p] != 0;
    nbill += tin == nullptr || tin[p] != 0;
  }
  ndone = block_sum(ndone, red);
  nbill = block_sum(nbill, red);
  const bool finish = ndone == static_cast<unsigned>(P) || it >= max_it;
  if (threadIdx.x == 0) {
    *nc += nbill;
    if (!finish) {
      *it_p = it;
      *row_p = s * max_it + it;
    }
  }
  if (!finish) return;

  // step s ends: its accepting fraction and median final bracket
  const unsigned k1 = (P - 1) / 2, k2 = P / 2;
  const unsigned key1 = select_key(tl, tr, P, k1, hist, sel);
  unsigned key2 = key1;
  if (k2 != k1) {
    unsigned le = 0, above = 0xffffffffu;
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      const unsigned key = width_key(__fsub_rn(tr[p], tl[p]));
      if (key <= key1) ++le;
      else above = min(above, key);
    }
    le = block_sum(le, red);
    above = block_min(above, red);
    key2 = le > k2 ? key1 : above;
  }
  if (threadIdx.x == 0) {
    accs[s] = __fdiv_rn(static_cast<float>(ndone), static_cast<float>(P));
    widths[s] = __fmul_rn(__fadd_rn(key_width(key1), key_width(key2)),
                          0.5f);
  }
  __syncthreads();   // every width is read before the chords overwrite it

  // the next step: every walker from its point, on its next direction
  // and full chord, a warp a walker
  const int64_t s1 = s + 1;
  if (s1 < nsteps) {
    const float* dn = dirbank + s1 * P * static_cast<int64_t>(d);
    const int lane = threadIdx.x & 31;
    const int nwarps = blockDim.x >> 5;
    for (int p = threadIdx.x >> 5; p < P; p += nwarps) {
      const int64_t off = static_cast<int64_t>(p) * d;
      float lo = -CUDART_INF_F, hi = CUDART_INF_F;
      for (int k = lane; k < d; k += 32) {
        const float uk = un[off + k], vk = dn[off + k];
        u[off + k] = uk;
        v[off + k] = vk;
        chord(uk, vk, lo, hi);
      }
      chord_warp_fold(lo, hi);
      if (lane == 0) {
        tl[p] = lo;
        tr[p] = hi;
        done[p] = 0;
      }
    }
  }
  if (threadIdx.x == 0) {
    *s_p = s1;
    *it_p = 0;
    *row_p = s1 < nsteps ? s1 * max_it
                         : static_cast<int64_t>(nsteps) * max_it - 1;
    *flag = s1 >= nsteps ? 1 : 0;
  }
}

}  // namespace

// tin: nullptr where every row is billed; the caller checks that
// nsteps, max_it, P and d are at least 1 and P below 2**24 (the done
// count and P are exact as floats)
extern "C" int un_sync_update(const float* Lp, const uint8_t* tin,
                              const float* ts, const float* tlc,
                              const float* trc, const float* Lmin,
                              const float* dirbank, int nsteps, int max_it,
                              int P, int d, float* u, float* v, float* tl,
                              float* tr, float* un, float* Ln, uint8_t* done,
                              int64_t* nc, int64_t* s, int64_t* it,
                              int64_t* row, uint8_t* flag, float* accs,
                              float* widths, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t threads = static_cast<int64_t>(P) * 32;
  const int blocks = static_cast<int>((threads + kWalkerThreads - 1)
                                      / kWalkerThreads);
  sync_walker_kernel<<<blocks, kWalkerThreads, 0, st>>>(
      Lp, ts, tlc, trc, Lmin, s, nsteps, P, d, u, v, tl, tr, un, Ln, done);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  sync_step_kernel<<<1, kStepThreads, 0, st>>>(
      tin, dirbank, nsteps, max_it, P, d, u, v, tl, tr, un, done, nc, s, it,
      row, flag, accs, widths);
  return static_cast<int>(cudaGetLastError());
}
