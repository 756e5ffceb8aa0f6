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
// integers only, so they match the reference bit for bit. live_L holds
// no NaN (padding is +inf); a NaN row is never accepted and has rank 0
// and dup 0, as in the reference.
//
// Bound on an H100: the dependent chain. Each accepted row changes the
// minimum the next row is tested against, so the accepted rows are a
// chain of argmin reductions over the live set, each some hundred
// cycles of latency on one SM. The bytes (~120 KB at P 4096) and the
// compares (~3 per row and live value) would take about 0.1 us on the
// whole card.
//
// The design takes the chain apart from the counts, in two kernels:
//
// 1. The chain (one CTA) writes accept, worst and Lmin of every row and
//    the final live set. Live values are held as order-preserving
//    uint32 keys (-0.0 mapped to +0.0, so that equal floats have equal
//    keys; the sign of a stored zero is kept in a bit mask). Rows come
//    32 at a time, lane j holding row j: a ballot of the rows the
//    current minimum would accept finds the next accepted row at once,
//    the rows before it are written as rejected in parallel, and only
//    an accepted row replaces a value and folds the minimum again: one
//    chain step per accepted row, not one per row. The fold gives the
//    minimum key (__reduce_min_sync over the lanes' minima), then the
//    lowest slot holding it (a second __reduce_min_sync over the holding
//    lanes' lowest slots, so that a tie goes to the lowest slot, not the
//    lowest lane).
//    * npad <= 1024 (the port runs 128, 256 and 512): warp 0 alone,
//      lane l holding slots l, l+32, ... in registers (K = npad/32
//      rounded up to a power of two, at least 4; loops unrolled, so that
//      no register is indexed at run time). No block barrier and no
//      shared-memory round per step.
//    * 1024 < npad <= 32768: one 1024-thread CTA, the values in shared
//      memory, thread t owning slots t, t+1024, ... and caching its
//      minimum and lowest slot; a fold is a warp fold, one barrier and a
//      fold of the 32 warp parts.
//    Rows after the last valid row cannot change the live set: their
//    accept, worst and Lmin are written afterwards in parallel.
//
// 2. The counts (P/32 CTAs of 8 warps, a warp per 4 rows) write rank
//    and the flags. Since every accepted row i swaps the minimum M_i it
//    replaced for its own L_i, the live set before row p is the initial
//    one plus L_i and minus M_i for each accepted i < p. So a count over
//    it (of values below L_p, equal to L_p, equal to Lmin_p) is the
//    count over the initial live set plus, for each earlier accepted
//    row, the count's change from that swap. Each CTA reads the earlier
//    rows' records 256 at a time and compacts the accepted ones in
//    shared memory; the lanes of a warp split the live set and the
//    accepted rows. Float compares, as the reference counts: -0.0
//    equals +0.0 and a NaN row counts nothing.
//
// un_consume_scan launches both on the caller's stream and picks the
// chain's instantiation from npad.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNone = 0xffffffffu;  // no key / no slot
constexpr int kWarpCtaThreads = 128;     // warp 0 runs the chain
constexpr int kCtaThreads = 1024;        // npad > 1024: 32 warps run it
constexpr int kCtaWarps = kCtaThreads / 32;
constexpr int kCountThreads = 256;       // the counts: 8 warps per CTA,
constexpr int kCountWarps = kCountThreads / 32;
constexpr int kRowsPerWarp = 4;          // 4 rows per warp
constexpr int kCountRows = kCountWarps * kRowsPerWarp;

// Order-preserving key: for floats a, b (no NaN) a < b iff
// fkey(a) < fkey(b), and a == b iff fkey(a) == fkey(b).
__device__ __forceinline__ uint32_t fkey(float v) {
  uint32_t b = __float_as_uint(v);
  if (b == 0x80000000u) b = 0u;  // -0.0 -> +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float unkey(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ bool is_negzero(float v) {
  return __float_as_uint(v) == 0x80000000u;
}

// The minimum of the live set: its key, the lowest slot holding it, and
// whether the value stored at that slot is -0.0.
struct Min {
  uint32_t key;
  uint32_t slot;
  bool negz;
};

__device__ __forceinline__ float min_value(const Min& g) {
  return g.negz ? -0.0f : unkey(g.key);
}

// Folds the lanes' parts (a minimum key, the lowest slot holding it,
// whether that slot holds -0.0) into the warp's; every lane gets it.
__device__ __forceinline__ Min warp_fold(uint32_t key, uint32_t slot,
                                         bool negz) {
  Min g;
  g.key = __reduce_min_sync(kFull, key);
  g.slot = __reduce_min_sync(kFull, key == g.key ? slot : kNone);
  g.negz = false;
  if (g.key == fkey(0.0f))  // the stored zero may be -0.0
    g.negz = __any_sync(kFull, slot == g.slot && negz) != 0;
  return g;
}

// Index of the last row with rows_valid > 0.5, or -1; every thread of
// the CTA takes part, and it ends with a barrier.
__device__ int last_valid_row(const float* rows_valid, int P, int* shared) {
  const int tid = threadIdx.x;
  if (tid == 0) *shared = -1;
  __syncthreads();
  int lv = -1;
#pragma unroll 8
  for (int p = tid; p < P; p += blockDim.x)
    if (rows_valid[p] > 0.5f) lv = p;
  lv = __reduce_max_sync(kFull, lv);
  if ((tid & 31) == 0 && lv >= 0) atomicMax(shared, lv);
  __syncthreads();
  return *shared;
}

// Trees over a register array with compile-time indices: log2(N) deep,
// where a loop would be a chain of N dependent instructions. The OR is
// opaque to the compiler, which would otherwise turn a tree of ORs of
// disjoint bits back into a chain of additions.
__device__ __forceinline__ uint32_t bor(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("or.b32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

template <int N>
__device__ __forceinline__ uint32_t tree_or(const uint32_t* t) {
  if constexpr (N == 1) {
    return t[0];
  } else {
    return bor(tree_or<N / 2>(t), tree_or<N / 2>(t + N / 2));
  }
}

template <int N>
__device__ __forceinline__ uint32_t tree_min(const uint32_t* t) {
  if constexpr (N == 1) {
    return t[0];
  } else {
    return min(tree_min<N / 2>(t), tree_min<N / 2>(t + N / 2));
  }
}

// npad <= 1024: the live set in one warp's registers, lane l holding
// slots k*32 + l (k < K) as keys, kNone past npad.
template <int K>
struct RegLive {
  uint32_t key[K];
  uint32_t negz = 0;  // bit k: slot k*32 + lane holds -0.0

  __device__ void load(const float* live_L, int npad, int lane) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = k * 32 + lane;
      const float v = s < npad ? live_L[s] : 0.0f;
      key[k] = s < npad ? fkey(v) : kNone;
      negz |= (is_negzero(v) ? 1u : 0u) << k;
    }
  }

  __device__ Min fold(int lane) const {
    const uint32_t m = tree_min<K>(key);
    uint32_t at[K];  // which of the lane's keys hold m
#pragma unroll
    for (int k = 0; k < K; ++k) at[k] = key[k] == m ? 1u << k : 0u;
    const int k0 = __ffs(tree_or<K>(at)) - 1;
    return warp_fold(m, static_cast<uint32_t>(k0 * 32 + lane),
                     (negz >> k0) & 1u);
  }

  // The lane owning g's slot stores v there (selects, not a branch).
  __device__ void replace(const Min& g, float v, int lane) {
    const bool own = (g.slot & 31u) == static_cast<uint32_t>(lane);
    const int ko = static_cast<int>(g.slot >> 5);
    const uint32_t kv = fkey(v);
#pragma unroll
    for (int k = 0; k < K; ++k) key[k] = own && k == ko ? kv : key[k];
    const uint32_t nz =
        (negz & ~(1u << ko)) | ((is_negzero(v) ? 1u : 0u) << ko);
    negz = own ? nz : negz;
  }

  __device__ void store(float* out, int npad, int lane) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = k * 32 + lane;
      if (s < npad) out[s] = ((negz >> k) & 1u) ? -0.0f : unkey(key[k]);
    }
  }
};

// npad > 1024: the live set in shared memory, thread t owning slots t,
// t + kCtaThreads, ... and caching its minimum over them.
struct SmemLive {
  float* lL;
  Min (*part)[kCtaWarps];  // [2][kCtaWarps], double-buffered
  int npad;
  int flip = 0;
  Min own;

  __device__ void cache() {
    own = Min{kNone, kNone, false};
    for (int s = threadIdx.x; s < npad; s += kCtaThreads) {
      const uint32_t k = fkey(lL[s]);
      if (k < own.key) own = Min{k, static_cast<uint32_t>(s),
                                 is_negzero(lL[s])};
    }
  }

  // Every thread of the CTA calls it: the warp folds, one barrier, then
  // every warp folds the warp parts (the other buffer is the next
  // fold's, so that no second barrier is needed).
  __device__ Min fold(int lane) {
    const Min w = warp_fold(own.key, own.slot, own.negz);
    if (lane == 0) part[flip][threadIdx.x >> 5] = w;
    __syncthreads();
    const Min p = part[flip][lane];
    flip ^= 1;
    return warp_fold(p.key, p.slot, p.negz);
  }

  __device__ void replace(const Min& g, float v, int) {
    if (static_cast<int>(g.slot) % kCtaThreads != threadIdx.x) return;
    lL[g.slot] = v;
    cache();
  }
};

// Rows 0 .. nseq-1 through the live set: accept, worst slot and Lmin of
// each row into recs (by warp 0), the final minimum returned. Every
// warp that holds a part of the live set runs it with the same rows, so
// their ballots agree.
template <class Live>
__device__ Min run_chain(Live& live, const float* __restrict__ rows_L,
                         const float* __restrict__ rows_valid, int nseq,
                         float* __restrict__ recs) {
  const int lane = threadIdx.x & 31;
  const bool writer = threadIdx.x < 32;
  Min g = live.fold(lane);
  float Ln = lane < nseq ? rows_L[lane] : 0.0f;
  float Vn = lane < nseq ? rows_valid[lane] : 0.0f;
  for (int p0 = 0; p0 < nseq; p0 += 32) {
    const float L = Ln;  // lane j: row p0 + j
    const int n = min(32, nseq - p0);
    const uint32_t kL = fkey(L);
    const bool eligible = lane < n && Vn > 0.5f && L == L;  // not NaN
    const int pn = p0 + 32 + lane;
    Ln = pn < nseq ? rows_L[pn] : 0.0f;
    Vn = pn < nseq ? rows_valid[pn] : 0.0f;
    int pos = 0;   // rows before pos have their minimum
    Min seen = g;  // lane j: the minimum row p0 + j was tested against
    bool accepted = false;
    while (true) {
      const unsigned acc =
          __ballot_sync(kFull, eligible && lane >= pos && kL > g.key);
      const int next = acc ? __ffs(acc) - 1 : n;
      // rows pos .. next-1 rejected, row next accepted, all under g
      const bool now = lane >= pos && lane <= next;
      seen.key = now ? g.key : seen.key;
      seen.slot = now ? g.slot : seen.slot;
      seen.negz = now ? g.negz : seen.negz;
      accepted = now ? lane == next : accepted;
      if (next >= n) break;
      live.replace(g, __shfl_sync(kFull, L, next), lane);
      g = live.fold(lane);
      pos = next + 1;
    }
    if (writer && lane < n) {
      float* r = recs + static_cast<size_t>(p0 + lane) * 5;
      r[0] = accepted ? 1.0f : 0.0f;
      r[1] = static_cast<float>(seen.slot);
      r[2] = min_value(seen);
    }
  }
  return g;
}

// Rows nseq .. P-1 (never accepted): accept 0, the final minimum.
__device__ void write_tail(int nseq, int P, const Min& g, float* recs) {
  for (int p = nseq + threadIdx.x; p < P; p += blockDim.x) {
    float* r = recs + static_cast<size_t>(p) * 5;
    r[0] = 0.0f;
    r[1] = static_cast<float>(g.slot);
    r[2] = min_value(g);
  }
}

template <int K>
__global__ void __launch_bounds__(kWarpCtaThreads)
scan_chain_warp(const float* __restrict__ live_L, int npad,
                const float* __restrict__ rows_L,
                const float* __restrict__ rows_valid, int P,
                float* __restrict__ live_L_out, float* __restrict__ recs) {
  __shared__ int last_valid;
  __shared__ Min fin;
  const int nseq = last_valid_row(rows_valid, P, &last_valid) + 1;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    RegLive<K> live;
    live.load(live_L, npad, lane);
    const Min g = run_chain(live, rows_L, rows_valid, nseq, recs);
    live.store(live_L_out, npad, lane);
    if (lane == 0) fin = g;
  }
  __syncthreads();
  write_tail(nseq, P, fin, recs);
}

__global__ void __launch_bounds__(kCtaThreads)
scan_chain_cta(const float* __restrict__ live_L, int npad,
               const float* __restrict__ rows_L,
               const float* __restrict__ rows_valid, int P,
               float* __restrict__ live_L_out, float* __restrict__ recs) {
  extern __shared__ float lL[];
  __shared__ Min part[2][kCtaWarps];
  __shared__ int last_valid;
  for (int s = threadIdx.x; s < npad; s += kCtaThreads) lL[s] = live_L[s];
  const int nseq = last_valid_row(rows_valid, P, &last_valid) + 1;
  SmemLive live{lL, part, npad};
  live.cache();
  const Min g = run_chain(live, rows_L, rows_valid, nseq, recs);
  __syncthreads();
  for (int s = threadIdx.x; s < npad; s += kCtaThreads)
    live_L_out[s] = lL[s];
  write_tail(nseq, P, g, recs);
}

// rank and 2*plateau + dup of kCountRows rows per CTA, a warp per
// kRowsPerWarp rows, from the initial live set and the accept and Lmin
// records of the rows before (the note at the top of this file).
__global__ void __launch_bounds__(kCountThreads)
scan_counts(const float* __restrict__ live_L, int npad,
            const float* __restrict__ rows_L, int P,
            float* __restrict__ recs) {
  __shared__ float accL[kCountThreads], accM[kCountThreads];
  __shared__ int before_row[kCountThreads];
  __shared__ int wcount[kCountWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kCountRows;
  const int p0 = row0 + warp * kRowsPerWarp;  // this warp's first row
  float L[kRowsPerWarp], M[kRowsPerWarp];
  int lt[kRowsPerWarp], eqL[kRowsPerWarp], eqM[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int p = p0 + r;
    L[r] = p < P ? rows_L[p] : 0.0f;
    M[r] = p < P ? recs[static_cast<size_t>(p) * 5 + 2] : 0.0f;
    lt[r] = eqL[r] = eqM[r] = 0;  // #(< L), #(== L), #(== Lmin)
  }
  for (int s = lane; s < npad; s += 32) {
    const float v = live_L[s];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      lt[r] += v < L[r];
      eqL[r] += v == L[r];
      eqM[r] += v == M[r];
    }
  }
  // the earlier rows, kCountThreads at a time; the CTA's rows lie in the
  // last block
  for (int i0 = 0; i0 <= row0; i0 += kCountThreads) {
    const int i = i0 + tid;
    const float* ri = recs + static_cast<size_t>(i) * 5;
    const bool a = i < P && ri[0] > 0.5f;
    const unsigned bal = __ballot_sync(kFull, a);
    if (lane == 0) wcount[warp] = __popc(bal);
    __syncthreads();
    int before = __popc(bal & ((1u << lane) - 1u)), total = 0;
#pragma unroll
    for (int w = 0; w < kCountWarps; ++w) {
      before += w < warp ? wcount[w] : 0;
      total += wcount[w];
    }
    before_row[tid] = before;
    if (a) {
      accL[before] = rows_L[i];
      accM[before] = ri[2];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      // the block's accepted rows before row p (i0 <= row0 <= p)
      const int p = p0 + r;
      const int lim = p - i0 >= kCountThreads ? total : before_row[p - i0];
      for (int j = lane; j < lim; j += 32) {
        const float li = accL[j], mi = accM[j];
        lt[r] += (li < L[r]) - (mi < L[r]);
        eqL[r] += (li == L[r]) - (mi == L[r]);
        eqM[r] += (li == M[r]) - (mi == M[r]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int p = p0 + r;
    const int rank = __reduce_add_sync(kFull, lt[r]);
    const int neqL = __reduce_add_sync(kFull, eqL[r]);
    const int neqM = __reduce_add_sync(kFull, eqM[r]);
    if (lane == 0 && p < P) {
      float* rec = recs + static_cast<size_t>(p) * 5;
      rec[3] = static_cast<float>(rank);
      rec[4] = (neqM > 1 ? 2.0f : 0.0f) + (neqL > 0 ? 1.0f : 0.0f);
    }
  }
}

template <int K>
void launch_warp(const float* live_L, int npad, const float* rows_L,
                 const float* rows_valid, int P, float* live_L_out,
                 float* recs, cudaStream_t stream) {
  scan_chain_warp<K><<<1, kWarpCtaThreads, 0, stream>>>(
      live_L, npad, rows_L, rows_valid, P, live_L_out, recs);
}

}  // namespace

extern "C" int un_consume_scan(const float* live_L, int npad,
                               const float* rows_L, const float* rows_valid,
                               int P, float* live_L_out, float* recs,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npad <= 128) {
    launch_warp<4>(live_L, npad, rows_L, rows_valid, P, live_L_out, recs, s);
  } else if (npad <= 256) {
    launch_warp<8>(live_L, npad, rows_L, rows_valid, P, live_L_out, recs, s);
  } else if (npad <= 512) {
    launch_warp<16>(live_L, npad, rows_L, rows_valid, P, live_L_out, recs,
                    s);
  } else if (npad <= 1024) {
    launch_warp<32>(live_L, npad, rows_L, rows_valid, P, live_L_out, recs,
                    s);
  } else {
    const size_t smem = static_cast<size_t>(npad) * sizeof(float);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          scan_chain_cta, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    scan_chain_cta<<<1, kCtaThreads, smem, s>>>(live_L, npad, rows_L,
                                                rows_valid, P, live_L_out,
                                                recs);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || P == 0) return static_cast<int>(err);
  scan_counts<<<(P + kCountRows - 1) / kCountRows, kCountThreads, 0, s>>>(
      live_L, npad, rows_L, P, recs);
  return static_cast<int>(cudaGetLastError());
}
