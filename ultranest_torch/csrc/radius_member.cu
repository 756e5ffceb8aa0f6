// K1: MLFriends radius membership of proposal candidates.
//
// Replaces the Pallas kernel ultranest_tpu/ops/pallas_kernels.py
// (_member_kernel / _radius_member_call, reached from
// fused._radius_member): for each candidate, is any valid live point
// within squared radius r2?
//
// Bound on an H100: arithmetic. A candidate outside needs its distance
// to every valid live point (3 d operations and a compare each), one
// inside at least one; the inputs are a few MB and stay in L2. At the
// shapes the region path gives it (a few hundred live points, 4096 to
// 131072 candidates) the kernel is far from that bound for another
// reason: one thread walking all live rows alone is one long dependent
// chain, and 4096 such threads leave most of the card empty.
// Design (the core is csrc/member_core.cuh):
// * G lanes share a candidate (G a power of two, 1..32, chosen by the
//   caller from M so that a launch puts about 65536 threads on the
//   card: 16 at M 4096, 1 at M 131072); lane g tests rows g, g + G, ...,
//   eight at a time with independent sums.
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
// Arithmetic: acc += diff * diff in axis order k = 0..d-1, the
// subtract, multiply and add each rounded on their own. That is the
// arithmetic of the plain torch version and of the reference, so
// membership agrees bit for bit, boundary rows included. A NaN
// candidate is no member (no acc <= r2 holds).
#include <cuda_runtime.h>
#include <stdint.h>

#include "member_core.cuh"

namespace {

using member_core::Cand;

constexpr int kThreads = 256;
constexpr int kLiveBytes = 72 * 1024;   // live tile in shared memory
constexpr int kCandBytes = 128 * 1024;  // staged candidates, d > 32 only

template <int D>
__global__ void __launch_bounds__(kThreads)
    radius_member_kernel(const float* __restrict__ tpoints,
                         const int32_t* __restrict__ tmask, int npts,
                         const float* __restrict__ cands, int m, int d,
                         float r2, int log2g, int tile,
                         int32_t* __restrict__ out) {
  extern __shared__ float sh[];
  __shared__ int sh_count;
  float* sh_p = sh;  // [d][tile] live rows of this tile, compacted
  const int ncb = kThreads >> log2g;  // candidates of this block
  const int cb = threadIdx.x >> log2g;
  const long long j0 = static_cast<long long>(blockIdx.x) * ncb;
  const long long j = j0 + cb;
  const bool active = j < m;
  Cand<D> c;
  if constexpr (D > 0) {
    c.load(cands, d, 1, j, d, active);
  } else {
    // [k][candidate]: the lanes of a group read one address, the groups
    // of a warp neighbouring ones; read back after the first barrier
    float* sh_c = sh + static_cast<size_t>(d) * tile;
    for (int t = threadIdx.x; t < ncb; t += kThreads) {
      const bool in = j0 + t < m;
      const float* src = cands + (in ? j0 + t : 0) * d;
      for (int k = 0; k < d; ++k) sh_c[k * ncb + t] = in ? src[k] : 0.0f;
    }
    c.p = sh_c + cb;
    c.step = ncb;
  }
  bool hit = !active;
  for (int row0 = 0; row0 < npts; row0 += tile) {
    if (threadIdx.x == 0) sh_count = 0;
    __syncthreads();
    member_core::stage_live_tile(tpoints, d, 1, tmask, row0,
                                 min(tile, npts - row0), d, sh_p, tile,
                                 &sh_count);
    __syncthreads();
    hit = member_core::group_any_within(c, d, sh_p, tile, sh_count, log2g,
                                        r2, hit);
    // doubles as the barrier before the next tile overwrites sh_p
    if (row0 + tile < npts && __syncthreads_and(hit)) break;
  }
  if (active && (threadIdx.x & ((1 << log2g) - 1)) == 0) out[j] = hit ? 1 : 0;
}

template <int D>
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
        radius_member_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (static_cast<long long>(m) + ncb - 1) / ncb;
  radius_member_kernel<D><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      tpoints, tmask, npts, cands, m, d, r2, log2g, tile, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// group: lanes per candidate, a power of two from 1 to 32 (the caller's
// choice: ops/kernels.py member_group_size; the card tests force each)
extern "C" int un_radius_member(const float* tpoints, const int32_t* tmask,
                                int npts, const float* cands, int m, int d,
                                float r2, int group, int32_t* out,
                                void* stream) {
  if (m <= 0) return 0;
  if (group < 1 || group > 32 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int log2g = 0;
  while ((1 << log2g) < group) ++log2g;
  if ((1 << log2g) != group) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 4)
    return launch<4>(tpoints, tmask, npts, cands, m, d, r2, log2g, out, s);
  if (d <= 8)
    return launch<8>(tpoints, tmask, npts, cands, m, d, r2, log2g, out, s);
  if (d <= 16)
    return launch<16>(tpoints, tmask, npts, cands, m, d, r2, log2g, out, s);
  if (d <= 32)
    return launch<32>(tpoints, tmask, npts, cands, m, d, r2, log2g, out, s);
  return launch<0>(tpoints, tmask, npts, cands, m, d, r2, log2g, out, s);
}
