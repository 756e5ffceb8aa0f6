// K2: bootstrapped MLFriends radius.
//
// Replaces the Pallas kernel ultranest_tpu/ops/pallas_kernels.py
// (_bootstrap_kernel / _bootstrap_radius_call, reached from
// ops/bootstrap._bootstrap_radius): over B rounds of selection masks,
// the largest squared distance from a valid unselected live point to
// its nearest selected one.
//
// Bound on an H100: arithmetic, B x N x N x d subtract-multiply-adds
// (30 x 512 x 512 x 2 = 16 M at the eggbox rebuild; 1 G at N 2048,
// d 8). The Pallas kernel kept the N x N matrix in VMEM; here the
// distances are recomputed per (round, column) instead of stored, so
// nothing but the points and the masks is read.
// Design: grid (column blocks of 256, rounds). One thread per column
// j; the rows are staged tile by tile in shared memory with the
// round's selection bytes. Each thread takes the min over selected
// rows; the block takes the max over its valid unselected columns,
// and blocks and rounds merge with atomicMax on the int bits of the
// non-negative result into a scalar set to 0 first -- the reference's
// scan carry also starts at 0.0 (ops/bootstrap.py:104-114).
// Arithmetic as in K1: separately rounded multiply and add, axis order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 1e30f;

__global__ void bootstrap_radius_kernel(const float* __restrict__ tpoints,
                                        const uint8_t* __restrict__ valid,
                                        const uint8_t* __restrict__ masks,
                                        int npad, int d, int tile,
                                        unsigned int* __restrict__ out) {
  extern __shared__ float sh_pts[];
  uint8_t* sh_sel = reinterpret_cast<uint8_t*>(sh_pts + tile * d);
  __shared__ float warp_max[kThreads / 32];
  const uint8_t* sel = masks + static_cast<size_t>(blockIdx.y) * npad;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const bool outside = j < npad && valid[j] != 0 && sel[j] == 0;
  const float* b = tpoints + static_cast<size_t>(outside ? j : 0) * d;
  float mind = kBig;
  for (int base = 0; base < npad; base += tile) {
    const int nt = min(tile, npad - base);
    for (int t = threadIdx.x; t < nt * d; t += blockDim.x)
      sh_pts[t] = tpoints[static_cast<size_t>(base) * d + t];
    for (int t = threadIdx.x; t < nt; t += blockDim.x)
      sh_sel[t] = sel[base + t];
    __syncthreads();
    if (outside) {
      for (int i = 0; i < nt; ++i) {
        if (sh_sel[i] == 0) continue;
        const float* a = sh_pts + i * d;
        float acc = 0.0f;
        for (int k = 0; k < d; ++k) {
          const float diff = __fsub_rn(a[k], b[k]);
          acc = __fadd_rn(acc, __fmul_rn(diff, diff));
        }
        mind = fminf(mind, acc);
      }
    }
    __syncthreads();
  }
  float v = outside ? mind : -1.0f;
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : -1.0f;
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, off));
    if (threadIdx.x == 0 && v > 0.0f) atomicMax(out, __float_as_uint(v));
  }
}

}  // namespace

extern "C" int un_bootstrap_radius(const float* tpoints, const uint8_t* valid,
                                   const uint8_t* masks, int npad,
                                   int nrounds, int d, float* out,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float), s);
  if (err != cudaSuccess || nrounds <= 0 || npad <= 0)
    return static_cast<int>(err);
  const int per_point = d * static_cast<int>(sizeof(float)) + 1;
  int tile = (40 * 1024) / per_point;
  tile = tile < 1 ? 1 : (tile > 1024 ? 1024 : tile);
  const size_t smem = static_cast<size_t>(tile) * per_point;
  dim3 grid((npad + kThreads - 1) / kThreads, nrounds);
  bootstrap_radius_kernel<<<grid, kThreads, smem, s>>>(
      tpoints, valid, masks, npad, d, tile,
      reinterpret_cast<unsigned int*>(out));
  return static_cast<int>(cudaGetLastError());
}
