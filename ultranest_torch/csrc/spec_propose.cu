// K4: the propose half of one round of the speculative-shrink walk.
//
// Replaces the first half of the lax.while_loop body of the JAX
// package's spec walk, ultranest_tpu/popfused.py:575-585 (_build_spec;
// an XLA loop, not a Pallas kernel). For each walker p, with xi the
// round's row xibank[it] (it: the round counter on the device):
//   tlc, trc = tl[p], tr[p]
//   for j in 0..D-1:
//     t = tlc + xi[p, j] * (trc - tlc)      ts[p, j] = t
//     tlc = t < 0 ? t : tlc ;  trc = t >= 0 ? t : trc
//   up[p*D + j, k] = u[p, k] + ts[p, j] * v[p, k]
// and writes ts (P, D), the fully shrunk tlc, trc (P,) and the rows up
// (P*D, d), the likelihood's input.
//
// Arithmetic: every subtract, multiply and add is rounded on its own
// (__fsub_rn, __fmul_rn, __fadd_rn, which nvcc never contracts into a
// fused multiply-add), as the torch operators of the plain version
// round them, so the two agree bit for bit. A NaN t moves neither end
// of the bracket (both compares are false), as in torch.
//
// Bound on an H100: bytes. The rows are the output: P*D*d floats
// (6.55 MB at P 4096, D 8, d 50: about 2.0 us at 3.35 TB/s), against
// (2 d + 2 + D) floats a walker read. Design: a block takes 32
// walkers. Its first warp runs their chains, one walker a lane (D
// dependent steps), and writes ts; after a barrier the whole block
// writes the block's rows as one contiguous range, neighbouring
// threads on neighbouring floats, reading u and v (d contiguous floats
// a walker, D times from L1) and ts back.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWalkers = 32;   // walkers a block
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
spec_propose_kernel(const float* __restrict__ u, const float* __restrict__ v,
                    const float* __restrict__ tl, const float* __restrict__ tr,
                    const float* __restrict__ xibank,
                    const int64_t* __restrict__ it, int max_rounds, int P,
                    int D, int d, float* __restrict__ ts,
                    float* __restrict__ tlc_out, float* __restrict__ trc_out,
                    float* __restrict__ up) {
  const int p0 = blockIdx.x * kWalkers;
  const int nw = min(kWalkers, P - p0);
  if (threadIdx.x < nw) {
    const int p = p0 + threadIdx.x;
    // the host loop runs at most max_rounds rounds; the clamp only
    // keeps a miscounted round inside the bank
    int64_t r = *it;
    r = r < 0 ? 0 : (r >= max_rounds ? max_rounds - 1 : r);
    const float* xi = xibank + (r * P + p) * static_cast<int64_t>(D);
    float tlc = tl[p], trc = tr[p];
    float* tsp = ts + static_cast<int64_t>(p) * D;
    for (int j = 0; j < D; ++j) {
      const float t = __fadd_rn(tlc, __fmul_rn(xi[j], __fsub_rn(trc, tlc)));
      tsp[j] = t;
      if (t < 0.0f) tlc = t;
      if (t >= 0.0f) trc = t;
    }
    tlc_out[p] = tlc;
    trc_out[p] = trc;
  }
  __syncthreads();   // the block's ts, written above, are read below
  const int64_t Dd = static_cast<int64_t>(D) * d;
  const int64_t base = static_cast<int64_t>(p0) * Dd;
  const int64_t n = static_cast<int64_t>(nw) * Dd;
  for (int64_t e = threadIdx.x; e < n; e += kThreads) {
    const int64_t w = e / Dd;
    const int64_t rem = e - w * Dd;
    const int64_t j = rem / d;
    const int64_t k = rem - j * d;
    const int64_t p = p0 + w;
    const float t = ts[p * D + j];
    up[base + e] = __fadd_rn(u[p * d + k], __fmul_rn(t, v[p * d + k]));
  }
}

}  // namespace

extern "C" int un_spec_propose(const float* u, const float* v,
                               const float* tl, const float* tr,
                               const float* xibank, const int64_t* it,
                               int max_rounds, int P, int D, int d, float* ts,
                               float* tlc, float* trc, float* up,
                               void* stream) {
  if (P == 0) return 0;
  const int blocks = (P + kWalkers - 1) / kWalkers;
  spec_propose_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      u, v, tl, tr, xibank, it, max_rounds, P, D, d, ts, tlc, trc, up);
  return static_cast<int>(cudaGetLastError());
}
