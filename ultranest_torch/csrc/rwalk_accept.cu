// K7: one step of the population random walk after the likelihood: the
// acceptance, and the next step's proposal.
//
// Replaces the lax.scan body of the JAX package's random-walk engine,
// ultranest_tpu/popfused.py:1612-1621 (_build_rwalk; an XLA loop, not a
// Pallas kernel), but for the matrix product, which the JAX package
// leaves to XLA and the port to torch.matmul: m_s = eps_s @ axes^T for
// every step, computed before the walk. Given the proposed rows up (P,
// d) = u + scale * m_s, their likelihoods Lev (P,) and, where the
// p-space filter ran, the rows it let through (tin), for each walker p:
//   inside = every coordinate of up[p] in (0, 1) (a NaN is outside)
//   Lp = inside ? Lev : -inf;  acc = inside && Lp > Lmin
//   acc: u[p] = up[p], L[p] = Lp
//   nacc += acc;  nc += inside && tin (int64 sums, exact in any order)
// and, given the next step's products m = m_{s+1}, the next proposal
// from the updated point, in place:
//   up[p] = u[p] + scale * m[p] (a multiply, then an add, each rounded
//   on its own, as torch's two elementwise kernels round them)
// The last step is given no m and writes no proposal. The prologue
// mode (no likelihoods) accepts nothing and writes step 0's proposal.
// Each walker owns its rows, so the updates are in place.
//
// Bound on an H100: bytes, far below a launch. A step reads every
// walker's row of up, its likelihood and filter row, its point and the
// next products, and writes the next proposal and an accepted walker's
// point: at P 128, d 8 about 17 KB, some nanoseconds at 3.35 TB/s.
// Design: one warp a walker, its lanes over the coordinates (the inside
// test is a warp vote, __all_sync); a lane loads its first coordinate's
// proposal, point and product together, before the vote, so that a step
// waits on one round of loads. The counts are summed in shared memory,
// one 64-bit atomic a counter a block, as K5 sums its own. Folding the
// proposal here takes the two torch elementwise kernels that built it
// out of every step: a step is the likelihood and this kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rwalk_step_kernel(const float* __restrict__ Lev,
                  const uint8_t* __restrict__ tin, float* __restrict__ up,
                  const float* __restrict__ Lmin_p,
                  const float* __restrict__ m,
                  const float* __restrict__ scale_p, int P, int d,
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
    const float scale = m != nullptr ? *scale_p : 0.0f;
    // the first coordinate of each lane, loaded at once
    float x0 = 0.0f, u0 = 0.0f, m0 = 0.0f;
    if (lane < d) {
      x0 = up[off + lane];
      u0 = u[off + lane];
      if (m != nullptr) m0 = m[off + lane];
    }
    bool acc = false;
    if (Lev != nullptr) {
      const float Lp = Lev[p];
      const float Lmin = *Lmin_p;
      bool in = lane >= d || (x0 > 0.0f && x0 < 1.0f);
      for (int k = lane + 32; k < d; k += 32) {
        const float x = up[off + k];
        in = in && x > 0.0f && x < 1.0f;
      }
      const bool inside = __all_sync(kFull, in);
      acc = inside && Lp > Lmin;
      if (lane == 0) {
        if (acc) {
          L[p] = Lp;
          atomicAdd(&counts[0], 1u);
        }
        if (inside && (tin == nullptr || tin[p] != 0))
          atomicAdd(&counts[1], 1u);
      }
    }
    if (lane < d) {
      const float x = acc ? x0 : u0;
      if (acc) u[off + lane] = x;
      if (m != nullptr) up[off + lane] = __fadd_rn(x, __fmul_rn(scale, m0));
    }
    for (int k = lane + 32; k < d; k += 32) {
      const float x = acc ? up[off + k] : u[off + k];
      if (acc) u[off + k] = x;
      if (m != nullptr)
        up[off + k] = __fadd_rn(x, __fmul_rn(scale, m[off + k]));
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

// Lev: nullptr for the prologue (accept nothing, write the proposal;
// tin and Lmin unused); tin: nullptr where every inside row is billed;
// m: nullptr where no next proposal is written (scale then unused)
extern "C" int un_rwalk_accept(const float* Lev, const uint8_t* tin,
                               float* up, const float* Lmin, const float* m,
                               const float* scale, int P, int d, float* u,
                               float* L, int64_t* nacc, int64_t* nc,
                               void* stream) {
  if (P == 0) return 0;
  const int64_t threads = static_cast<int64_t>(P) * 32;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  rwalk_step_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      Lev, tin, up, Lmin, m, scale, P, d, u, L, nacc, nc);
  return static_cast<int>(cudaGetLastError());
}
