// The radius membership kernel of K1 (radius_member.cu, row-major
// operands) and K1t (radius_member_t.cu, axis-major operands): one body,
// instantiated per layout. The core it is built from is member_core.cuh.
//
// For each candidate: is any valid live point within squared radius r2?
//
// * G lanes share a candidate (G a power of two, 1..32, the caller's
//   choice); lane g tests rows g, g + G, ..., eight at a time with
//   independent sums.
// * The candidate sits in registers: the kernel is instantiated for
//   d <= 4, 8, 16, 32 with the axis loop unrolled; for larger d the
//   block's candidates are staged in shared memory as [k][candidate].
// * The live set is staged once per block, valid rows only, axis-major;
//   up to 72 KB of it at a time (three blocks an SM), further tiles
//   behind a barrier, and the block leaves the tile loop once all of
//   its candidates have a hit (__syncthreads_and).
// * After each chunk of rows the warp votes once with the full mask and
//   folds the ballot per group; a group with a hit stops computing but
//   keeps voting until the whole warp leaves.
//
// The layout (kAxisMajor) fixes two things, both at compile time:
// * the strides. Row-major (N, d) and (M, d): point i's axis k at
//   base[i * d + k]. Axis-major (d, N) and (d, M): at base[k * N + i]
//   and base[k * M + i]; offsets are 64-bit, since k * M passes 2^31 at
//   the largest d and M.
// * which mask entries are valid rows: not 0 for row-major operands (K1,
//   as its plain version and the reference), above 0 for axis-major ones
//   (K1t, as its plain version and the reference: a negative entry is
//   an invalid row there).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "member_core.cuh"

namespace {

using member_core::Cand;

constexpr int kThreads = 256;
constexpr int kLiveBytes = 72 * 1024;   // live tile in shared memory
constexpr int kCandBytes = 128 * 1024;  // staged candidates, d > 32 only

template <int D, bool kAxisMajor>
__global__ void __launch_bounds__(kThreads)
    radius_member_kernel(const float* __restrict__ tpoints,
                         const int32_t* __restrict__ tmask, int npts,
                         const float* __restrict__ cands, int m, int d,
                         float r2, int log2g, int tile,
                         int32_t* __restrict__ out) {
  extern __shared__ float sh[];
  __shared__ int sh_count;
  // point i, axis k of an operand: base[i * si + k * sk]
  const long long tp_si = kAxisMajor ? 1 : d, tp_sk = kAxisMajor ? npts : 1;
  const long long cd_si = kAxisMajor ? 1 : d, cd_sk = kAxisMajor ? m : 1;
  float* sh_p = sh;  // [d][tile] live rows of this tile, compacted
  const int ncb = kThreads >> log2g;  // candidates of this block
  const int cb = threadIdx.x >> log2g;
  const long long j0 = static_cast<long long>(blockIdx.x) * ncb;
  const long long j = j0 + cb;
  const bool active = j < m;
  Cand<D> c;
  if constexpr (D > 0) {
    c.load(cands, cd_si, cd_sk, j, d, active);
  } else {
    // [k][candidate]: the lanes of a group read one address, the groups
    // of a warp neighbouring ones; read back after the first barrier
    float* sh_c = sh + static_cast<size_t>(d) * tile;
    for (int t = threadIdx.x; t < ncb; t += kThreads) {
      const bool in = j0 + t < m;
      const float* src = cands + (in ? j0 + t : 0) * cd_si;
      for (int k = 0; k < d; ++k)
        sh_c[k * ncb + t] = in ? src[k * cd_sk] : 0.0f;
    }
    c.p = sh_c + cb;
    c.step = ncb;
  }
  bool hit = !active;
  for (int row0 = 0; row0 < npts; row0 += tile) {
    if (threadIdx.x == 0) sh_count = 0;
    __syncthreads();
    member_core::stage_live_tile<kAxisMajor>(tpoints, tp_si, tp_sk, tmask,
                                             row0, min(tile, npts - row0), d,
                                             sh_p, tile, &sh_count);
    __syncthreads();
    hit = member_core::group_any_within(c, d, sh_p, tile, sh_count, log2g,
                                        r2, hit);
    // doubles as the barrier before the next tile overwrites sh_p
    if (row0 + tile < npts && __syncthreads_and(hit)) break;
  }
  if (active && (threadIdx.x & ((1 << log2g) - 1)) == 0) out[j] = hit ? 1 : 0;
}

template <int D, bool kAxisMajor>
int launch(const float* tpoints, const int32_t* tmask, int npts,
           const float* cands, int m, int d, float r2, int log2g,
           int32_t* out, cudaStream_t s) {
  const int ncb = kThreads >> log2g;
  const size_t cand_bytes =
      D > 0 ? 0 : static_cast<size_t>(ncb) * d * sizeof(float);
  if (cand_bytes > kCandBytes) return static_cast<int>(cudaErrorInvalidValue);
  int tile = kLiveBytes / (d * static_cast<int>(sizeof(float)));
  tile = tile < 1 ? 1 : (tile > npts ? (npts > 0 ? npts : 1) : tile);
  const size_t smem =
      static_cast<size_t>(tile) * d * sizeof(float) + cand_bytes;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        radius_member_kernel<D, kAxisMajor>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (static_cast<long long>(m) + ncb - 1) / ncb;
  radius_member_kernel<D, kAxisMajor>
      <<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
          tpoints, tmask, npts, cands, m, d, r2, log2g, tile, out);
  return static_cast<int>(cudaGetLastError());
}

// group: lanes per candidate, a power of two from 1 to 32 (the caller's
// choice: ops/kernels.py member_group_size; the card tests force each)
template <bool kAxisMajor>
int dispatch(const float* tpoints, const int32_t* tmask, int npts,
             const float* cands, int m, int d, float r2, int group,
             int32_t* out, void* stream) {
  if (m <= 0) return 0;
  if (group < 1 || group > 32 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int log2g = 0;
  while ((1 << log2g) < group) ++log2g;
  if ((1 << log2g) != group) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 4)
    return launch<4, kAxisMajor>(tpoints, tmask, npts, cands, m, d, r2, log2g,
                                 out, s);
  if (d <= 8)
    return launch<8, kAxisMajor>(tpoints, tmask, npts, cands, m, d, r2, log2g,
                                 out, s);
  if (d <= 16)
    return launch<16, kAxisMajor>(tpoints, tmask, npts, cands, m, d, r2,
                                  log2g, out, s);
  if (d <= 32)
    return launch<32, kAxisMajor>(tpoints, tmask, npts, cands, m, d, r2,
                                  log2g, out, s);
  return launch<0, kAxisMajor>(tpoints, tmask, npts, cands, m, d, r2, log2g,
                               out, s);
}

}  // namespace
