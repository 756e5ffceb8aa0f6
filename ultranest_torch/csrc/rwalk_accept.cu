// K7: the acceptance half of one step of the population random walk.
//
// Replaces the lax.scan body after the likelihood in the JAX package's
// random-walk engine, ultranest_tpu/popfused.py:1613-1621
// (_build_rwalk; an XLA loop, not a Pallas kernel). Given the proposed
// rows up (P, d) = u + scale * eps_s @ axes^T (a matrix product the JAX
// package leaves to XLA and the port to torch.matmul), their
// likelihoods Lev (P,) and, where the p-space filter ran, the rows it
// let through (tin), for each walker p:
//   inside = every coordinate of up[p] in (0, 1) (a NaN is outside)
//   Lp = inside ? Lev : -inf;  acc = inside && Lp > Lmin
//   acc: u[p] = up[p], L[p] = Lp
//   nacc += acc;  nc += inside && tin (int64 sums, exact in any order)
// The walker's point and likelihood are updated in place: each walker
// owns its row.
//
// Bound on an H100: bytes, far below a launch. A step reads every
// walker's row of up, its likelihood and filter row, and writes an
// accepted walker's row: at P 128, d 8 about 5 KB, a few nanoseconds at
// 3.35 TB/s. Design: one warp a walker, as K5 and K6, its lanes over
// the coordinates (the inside test is a warp vote, __all_sync); the
// counts are summed in shared memory, one 64-bit atomic a counter a
// block, as K5 sums its own.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rwalk_accept_kernel(const float* __restrict__ Lev,
                    const uint8_t* __restrict__ tin,
                    const float* __restrict__ up,
                    const float* __restrict__ Lmin_p, int P, int d,
                    float* __restrict__ u, float* __restrict__ L,
                    int64_t* __restrict__ nacc, int64_t* __restrict__ nc) {
  __shared__ unsigned counts[2];   // accepted, billed
  if (threadIdx.x < 2) counts[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t p = (static_cast<int64_t>(blockIdx.x) * kThreads
                     + threadIdx.x) / 32;
  if (p < P) {   // the same on every lane of the walker's warp
    const int64_t off = p * d;
    bool in = true;
    for (int k = lane; k < d; k += 32) {
      const float x = up[off + k];
      in = in && x > 0.0f && x < 1.0f;
    }
    if (__all_sync(kFull, in)) {
      const float Lp = Lev[p];
      if (Lp > *Lmin_p) {
        for (int k = lane; k < d; k += 32) u[off + k] = up[off + k];
        if (lane == 0) {
          L[p] = Lp;
          atomicAdd(&counts[0], 1u);
        }
      }
      if (lane == 0 && (tin == nullptr || tin[p] != 0))
        atomicAdd(&counts[1], 1u);
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 && counts[threadIdx.x]) {
    int64_t* dst = threadIdx.x == 0 ? nacc : nc;
    atomicAdd(reinterpret_cast<unsigned long long*>(dst),
              static_cast<unsigned long long>(counts[threadIdx.x]));
  }
}

}  // namespace

// tin: nullptr where every inside row is billed
extern "C" int un_rwalk_accept(const float* Lev, const uint8_t* tin,
                               const float* up, const float* Lmin, int P,
                               int d, float* u, float* L, int64_t* nacc,
                               int64_t* nc, void* stream) {
  if (P == 0) return 0;
  const int64_t threads = static_cast<int64_t>(P) * 32;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  rwalk_accept_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      Lev, tin, up, Lmin, P, d, u, L, nacc, nc);
  return static_cast<int>(cudaGetLastError());
}
