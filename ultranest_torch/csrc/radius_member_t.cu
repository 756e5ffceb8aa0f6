// K1t: MLFriends radius membership on transposed operands.
//
// Replaces the Pallas kernel evaluate/bench_pallas_membership.py
// (_member_kernel_t / pallas_member_t), the transposed-layout variant of
// K1: for each candidate j, is any valid live point i (tm[i] > 0) within
// squared radius r2? Live points arrive as tp_t (d, N) and candidates as
// cd_t (d, M), each axis a contiguous row.
//
// Bound on an H100: arithmetic, as K1 (M x N x d subtract-multiply-add;
// the inputs stay in L2). What the layout buys: thread j reads
// cd_t[k * M + j], so a warp's loads of one axis are 32 neighbouring
// floats (K1's row-major cands[j * d + k] is strided by d). Each block
// stages its candidates once in shared memory as [k][thread] (no bank
// conflicts) and the live points tile by tile as [k][i], read by all
// threads of the block as broadcasts. A thread stops computing at its
// first hit but keeps taking part in every barrier; the block leaves the
// tile loop once all of its candidates have a hit (__syncthreads_and).
//
// Arithmetic: acc += diff * diff in axis order k = 0..d-1, the subtract,
// multiply and add each rounded on their own (__fsub_rn / __fmul_rn /
// __fadd_rn, so nvcc cannot contract them into an FMA): the arithmetic
// of K1, of the plain torch version and of the reference, so membership
// agrees bit for bit, boundary candidates included.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void radius_member_t_kernel(const float* __restrict__ tp_t,
                                       const int32_t* __restrict__ tm,
                                       int npts,
                                       const float* __restrict__ cd_t, int m,
                                       int d, float r2,
                                       int32_t* __restrict__ out) {
  extern __shared__ float sh[];
  const int tile = blockDim.x;
  float* sh_c = sh;                    // d x tile candidates
  float* sh_p = sh + d * tile;         // d x tile live points
  int32_t* sh_m = reinterpret_cast<int32_t*>(sh_p + d * tile);
  const int tid = threadIdx.x;
  const int j = blockIdx.x * blockDim.x + tid;
  const bool active = j < m;
  // each thread reads back only its own column: no barrier needed
  if (active)
    for (int k = 0; k < d; ++k)
      sh_c[k * tile + tid] = cd_t[static_cast<size_t>(k) * m + j];
  bool hit = false;
  for (int base = 0; base < npts; base += tile) {
    const int nt = min(tile, npts - base);
    for (int t = tid; t < nt * d; t += blockDim.x) {
      const int k = t / nt, i = t - k * nt;
      sh_p[k * tile + i] = tp_t[static_cast<size_t>(k) * npts + base + i];
    }
    for (int t = tid; t < nt; t += blockDim.x) sh_m[t] = tm[base + t];
    __syncthreads();
    if (active && !hit) {
      for (int i = 0; i < nt; ++i) {
        if (sh_m[i] <= 0) continue;
        float acc = 0.0f;
        for (int k = 0; k < d; ++k) {
          const float diff = __fsub_rn(sh_c[k * tile + tid], sh_p[k * tile + i]);
          acc = __fadd_rn(acc, __fmul_rn(diff, diff));
        }
        if (acc <= r2) {
          hit = true;
          break;
        }
      }
    }
    // doubles as the barrier before the next tile overwrites sh_p
    if (__syncthreads_and(hit || !active)) break;
  }
  if (active) out[j] = hit ? 1 : 0;
}

}  // namespace

extern "C" int un_radius_member_t(const float* tp_t, const int32_t* tm,
                                  int npts, const float* cd_t, int m, int d,
                                  float r2, int32_t* out, void* stream) {
  if (m <= 0) return 0;
  const size_t smem =
      static_cast<size_t>(kThreads) * (2 * d * sizeof(float) + 4);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        radius_member_t_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (m + kThreads - 1) / kThreads;
  radius_member_t_kernel<<<blocks, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      tp_t, tm, npts, cd_t, m, d, r2, out);
  return static_cast<int>(cudaGetLastError());
}
