// K3: the segment consume scan.
//
// Replaces the XLA lax.scan of ultranest_tpu/segmentops.py:78-134
// (consume_scan; not a Pallas kernel, but torch has no scan and a host
// loop over P rows would cost thousands of launches). For each
// candidate row p in order, against the live likelihoods as they stand
// before the row:
//   worst = argmin(live_L)   (lowest index on ties, as jnp.argmin)
//   Lmin  = live_L[worst]
//   accept = valid_p > 0.5 && L_p > Lmin
//   rank = #(live_L < L_p), plateau = #(live_L == Lmin) > 1,
//   dup = any(live_L == L_p)
// write record [accept, worst, Lmin, rank, 2*plateau + dup], then
// replace live_L[worst] by L_p if accepted. Records are compares and
// integers only, so they match the reference bit for bit.
//
// Bound on an H100: latency. P sequential block-wide reductions over
// npad values (P <= 1024, npad = 512 on the eggbox); each row costs a
// few barriers, not bytes or flops.
// Design: one CTA. live_L sits in shared memory (dynamic, above 48 KB
// with the opt-in attribute). Each reduction carries (min, argmin,
// count of the min, rank, dup) in one pass, merged by warp shuffles
// and one shared-memory round. Rows after the last valid row cannot
// change the live set, so their records are computed afterwards in
// parallel, one warp per row, against the final state.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct Red {
  float m;    // running min
  int i;      // its lowest index (INT32_MAX: none yet)
  int c;      // how many values equal m
  int rank;   // #(v < L)
  int dup;    // any(v == L)
};

__device__ __forceinline__ Red merge(Red a, Red b) {
  Red r;
  if (b.m < a.m || (b.m == a.m && b.i < a.i)) {
    r.m = b.m;
    r.i = b.i;
  } else {
    r.m = a.m;
    r.i = a.i;
  }
  r.c = (a.m == b.m) ? a.c + b.c : (r.i == a.i ? a.c : b.c);
  r.rank = a.rank + b.rank;
  r.dup = a.dup | b.dup;
  return r;
}

__device__ __forceinline__ Red warp_reduce(Red r) {
  for (int off = 16; off > 0; off >>= 1) {
    Red o;
    o.m = __shfl_down_sync(0xffffffffu, r.m, off);
    o.i = __shfl_down_sync(0xffffffffu, r.i, off);
    o.c = __shfl_down_sync(0xffffffffu, r.c, off);
    o.rank = __shfl_down_sync(0xffffffffu, r.rank, off);
    o.dup = __shfl_down_sync(0xffffffffu, r.dup, off);
    r = merge(r, o);
  }
  return r;
}

// thread-local pass over the values t0, t0 + stride, ... of lL
__device__ __forceinline__ Red scan_values(const float* lL, int npad, int t0,
                                           int stride, float L) {
  Red r{INFINITY, INT32_MAX, 0, 0, 0};
  for (int t = t0; t < npad; t += stride) {
    const float v = lL[t];
    if (r.i == INT32_MAX || v < r.m) {
      r.m = v;
      r.i = t;
      r.c = 1;
    } else if (v == r.m) {
      r.c += 1;
    }
    r.rank += v < L;
    r.dup |= v == L;
  }
  return r;
}

__device__ __forceinline__ void write_record(float* rec, const Red& r,
                                             bool accept) {
  rec[0] = accept ? 1.0f : 0.0f;
  rec[1] = static_cast<float>(r.i);
  rec[2] = r.m;
  rec[3] = static_cast<float>(r.rank);
  rec[4] = (r.c > 1 ? 2.0f : 0.0f) + (r.dup ? 1.0f : 0.0f);
}

__global__ void consume_scan_kernel(const float* __restrict__ live_L,
                                    int npad,
                                    const float* __restrict__ rows_L,
                                    const float* __restrict__ rows_valid,
                                    int P, float* __restrict__ live_L_out,
                                    float* __restrict__ recs) {
  extern __shared__ float lL[];
  __shared__ Red warp_red[kWarps];
  __shared__ int last_valid;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int t = tid; t < npad; t += kThreads) lL[t] = live_L[t];
  if (tid == 0) last_valid = -1;
  __syncthreads();
  // rows past the last valid one never accept
  for (int p = tid; p < P; p += kThreads)
    if (rows_valid[p] > 0.5f) atomicMax(&last_valid, p);
  __syncthreads();
  const int nseq = last_valid + 1;

  for (int p = 0; p < nseq; ++p) {
    const float L = rows_L[p];
    Red r = warp_reduce(scan_values(lL, npad, tid, kThreads, L));
    if (lane == 0) warp_red[warp] = r;
    __syncthreads();
    if (warp == 0) {
      r = lane < kWarps ? warp_red[lane] : Red{INFINITY, INT32_MAX, 0, 0, 0};
      r = warp_reduce(r);
      if (lane == 0) {
        const bool accept = rows_valid[p] > 0.5f && L > r.m;
        write_record(recs + static_cast<size_t>(p) * 5, r, accept);
        if (accept) lL[r.i] = L;
      }
    }
    __syncthreads();
  }

  // the live set is final: remaining rows in parallel, one warp each
  for (int p = nseq + warp; p < P; p += kWarps) {
    const float L = rows_L[p];
    const Red r = warp_reduce(scan_values(lL, npad, lane, 32, L));
    if (lane == 0) write_record(recs + static_cast<size_t>(p) * 5, r, false);
  }
  for (int t = tid; t < npad; t += kThreads) live_L_out[t] = lL[t];
}

}  // namespace

extern "C" int un_consume_scan(const float* live_L, int npad,
                               const float* rows_L, const float* rows_valid,
                               int P, float* live_L_out, float* recs,
                               void* stream) {
  const size_t smem = static_cast<size_t>(npad) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        consume_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  consume_scan_kernel<<<1, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      live_L, npad, rows_L, rows_valid, P, live_L_out, recs);
  return static_cast<int>(cudaGetLastError());
}
