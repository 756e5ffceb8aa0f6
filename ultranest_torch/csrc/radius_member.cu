// K1: MLFriends radius membership of proposal candidates.
//
// Replaces the Pallas kernel ultranest_tpu/ops/pallas_kernels.py
// (_member_kernel / _radius_member_call, reached from
// fused._radius_member): for each candidate, is any valid live point
// within squared radius r2?
//
// Bound on an H100: arithmetic. M candidates x N live points x d axes
// of subtract-multiply-add (131072 x 512 x 2 = 134 M cell-axes at the
// largest eggbox batch); the inputs are a few MB and stay in L2.
// Design: one thread per candidate, blocks of 256. The live points are
// staged tile by tile in shared memory and read by all threads of the
// block. A thread stops computing at its first hit but keeps taking
// part in every barrier; the block leaves the tile loop as soon as all
// of its candidates have a hit (__syncthreads_and).
//
// Arithmetic: acc += diff * diff in axis order k = 0..d-1, with the
// multiply and the add rounded separately (__fmul_rn / __fadd_rn, so
// nvcc cannot contract them into an FMA). That is the arithmetic of
// the plain torch version and of the reference, so membership agrees
// bit for bit, boundary rows included.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void radius_member_kernel(const float* __restrict__ tpoints,
                                     const int32_t* __restrict__ tmask,
                                     int npts, const float* __restrict__ cands,
                                     int m, int d, float r2, int tile,
                                     int32_t* __restrict__ out) {
  extern __shared__ float sh_pts[];
  int32_t* sh_mask = reinterpret_cast<int32_t*>(sh_pts + tile * d);
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = j < m;
  const float* c = cands + static_cast<size_t>(active ? j : 0) * d;
  bool hit = false;
  for (int base = 0; base < npts; base += tile) {
    const int nt = min(tile, npts - base);
    for (int t = threadIdx.x; t < nt * d; t += blockDim.x)
      sh_pts[t] = tpoints[static_cast<size_t>(base) * d + t];
    for (int t = threadIdx.x; t < nt; t += blockDim.x)
      sh_mask[t] = tmask[base + t];
    __syncthreads();
    if (active && !hit) {
      for (int i = 0; i < nt; ++i) {
        if (sh_mask[i] == 0) continue;
        const float* a = sh_pts + i * d;
        float acc = 0.0f;
        for (int k = 0; k < d; ++k) {
          const float diff = __fsub_rn(a[k], c[k]);
          acc = __fadd_rn(acc, __fmul_rn(diff, diff));
        }
        if (acc <= r2) {
          hit = true;
          break;
        }
      }
    }
    // doubles as the barrier before the next tile overwrites sh_pts
    if (__syncthreads_and(hit || !active)) break;
  }
  if (active) out[j] = hit ? 1 : 0;
}

}  // namespace

extern "C" int un_radius_member(const float* tpoints, const int32_t* tmask,
                                int npts, const float* cands, int m, int d,
                                float r2, int32_t* out, void* stream) {
  if (m <= 0) return 0;
  const int per_point = d * static_cast<int>(sizeof(float)) + 4;
  int tile = (48 * 1024) / per_point;
  tile = tile < 1 ? 1 : (tile > kThreads ? kThreads : tile);
  const size_t smem = static_cast<size_t>(tile) * per_point;
  const int blocks = (m + kThreads - 1) / kThreads;
  radius_member_kernel<<<blocks, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      tpoints, tmask, npts, cands, m, d, r2, tile, out);
  return static_cast<int>(cudaGetLastError());
}
