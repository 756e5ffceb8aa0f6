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
// (2 d + 2 + D) floats a walker read. Design: one thread a group of 4
// neighbouring floats of one row (p, j), read and written as one
// 16-byte, two 8-byte or four 4-byte accesses, as the row's length and
// the pointers allow (d 100: 16 bytes, d 50 and 30: 8 bytes), so a
// block of 256 threads writes neighbouring floats and the grid holds
// every group of the output (1664 blocks at P 4096, D 8, d 50; 1600 at
// P 2048, D 8, d 100): several blocks on every SM, many stores in
// flight. Each thread reads its row's u and v first, then recomputes
// its walker's chain up to j from the round's row of xi, the same
// rounded steps, so no barrier and no hand-over of ts is needed (D <= 8
// steps on the bench's paths; the xi reads of one row are the same
// addresses for a warp's threads and come from L1). Its indices are
// 32-bit: a division by the groups of a row and one by D, none in a
// loop. Tried on an H100 and dropped: one thread a vector (twice the
// chains at d 50), 8 floats a thread, and one warp a walker writing its
// D*d floats as 16-byte stores (slower at the small shapes).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;   // xi values a thread loads before it steps

template <int VEC> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ float row_value(float u, float t, float v) {
  return __fadd_rn(u, __fmul_rn(t, v));
}

__device__ __forceinline__ float row_values(const float& u, float t,
                                            const float& v) {
  return row_value(u, t, v);
}
__device__ __forceinline__ float2 row_values(const float2& u, float t,
                                             const float2& v) {
  return make_float2(row_value(u.x, t, v.x), row_value(u.y, t, v.y));
}
__device__ __forceinline__ float4 row_values(const float4& u, float t,
                                             const float4& v) {
  return make_float4(row_value(u.x, t, v.x), row_value(u.y, t, v.y),
                     row_value(u.z, t, v.z), row_value(u.w, t, v.w));
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
spec_propose_kernel(const float* __restrict__ u, const float* __restrict__ v,
                    const float* __restrict__ tl, const float* __restrict__ tr,
                    const float* __restrict__ xibank,
                    const int64_t* __restrict__ it, int max_rounds,
                    unsigned P, unsigned D, unsigned d, unsigned tpr,
                    unsigned nthreads, float* __restrict__ ts,
                    float* __restrict__ tlc_out, float* __restrict__ trc_out,
                    float* __restrict__ up) {
  using V = typename Vec<VEC>::T;
  constexpr int kPer = 4 / VEC;   // vectors a thread
  const unsigned g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= nthreads) return;
  const unsigned row = g / tpr;   // candidate p*D + j
  const unsigned c = g - row * tpr;
  const unsigned p = row / D;
  const unsigned j = row - p * D;
  // the row's operands first: they do not wait for the chain
  const unsigned f0 = 4 * c;
  const V* ur = reinterpret_cast<const V*>(u + static_cast<size_t>(p) * d
                                           + f0);
  const V* vr = reinterpret_cast<const V*>(v + static_cast<size_t>(p) * d
                                           + f0);
  V uk[kPer], vk[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    if (f0 + q * VEC < d) {
      uk[q] = ur[q];
      vk[q] = vr[q];
    }
  }
  float tlc = tl[p], trc = tr[p];
  // the host loop runs at most max_rounds rounds; the clamp only keeps
  // a miscounted round inside the bank
  int64_t r = *it;
  r = r < 0 ? 0 : (r >= max_rounds ? max_rounds - 1 : r);
  const float* xi = xibank + (static_cast<size_t>(r) * P + p) * D;
  float t = 0.0f;
  for (unsigned i0 = 0; i0 <= j; i0 += kChunk) {
    float x[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q)
      x[q] = i0 + q <= j ? xi[i0 + q] : 0.0f;
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      if (i0 + q <= j) {
        t = __fadd_rn(tlc, __fmul_rn(x[q], __fsub_rn(trc, tlc)));
        if (t < 0.0f) tlc = t;
        if (t >= 0.0f) trc = t;
      }
    }
  }
  if (c == 0) {
    ts[row] = t;
    if (j == D - 1) {
      tlc_out[p] = tlc;
      trc_out[p] = trc;
    }
  }
  V* out = reinterpret_cast<V*>(up + static_cast<size_t>(row) * d + f0);
#pragma unroll
  for (int q = 0; q < kPer; ++q)
    if (f0 + q * VEC < d) out[q] = row_values(uk[q], t, vk[q]);
}

template <int VEC>
int launch(const float* u, const float* v, const float* tl, const float* tr,
           const float* xibank, const int64_t* it, int max_rounds, int P,
           int D, int d, float* ts, float* tlc, float* trc, float* up,
           cudaStream_t stream) {
  const unsigned tpr = static_cast<unsigned>((d + 3) / 4);
  const unsigned nthreads = static_cast<unsigned>(P) * D * tpr;
  const unsigned blocks = (nthreads + kThreads - 1) / kThreads;
  spec_propose_kernel<VEC><<<blocks, kThreads, 0, stream>>>(
      u, v, tl, tr, xibank, it, max_rounds, P, D, d, tpr, nthreads, ts, tlc,
      trc, up);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vec: floats a thread reads or writes in one access, 4, 2 or 1; the
// caller checks that d is a multiple of it and that u, v and up are
// aligned to 4 * vec bytes, and that P * D * d < 2**31
extern "C" int un_spec_propose(const float* u, const float* v,
                               const float* tl, const float* tr,
                               const float* xibank, const int64_t* it,
                               int max_rounds, int P, int D, int d, int vec,
                               float* ts, float* tlc, float* trc, float* up,
                               void* stream) {
  if (P == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    return launch<4>(u, v, tl, tr, xibank, it, max_rounds, P, D, d, ts, tlc,
                     trc, up, s);
  if (vec == 2)
    return launch<2>(u, v, tl, tr, xibank, it, max_rounds, P, D, d, ts, tlc,
                     trc, up, s);
  return launch<1>(u, v, tl, tr, xibank, it, max_rounds, P, D, d, ts, tlc,
                   trc, up, s);
}
