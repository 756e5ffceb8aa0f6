// K6: the update half of one shrink iteration of the sync walk, and the
// step boundary around it.
//
// Replaces the second half of the lax.while_loop body of the JAX
// package's sync engine, ultranest_tpu/popfused.py:849-863 (_build; an
// XLA loop, not a Pallas kernel), and the step boundary around that
// loop (:842, :865-870). A round is one shrink iteration of every
// walker: K4 (spec_propose.cu at D = 1) proposes t = tlc + xi (trc -
// tlc) and the row u + t v from bank row `row`, the likelihood
// evaluates the rows, and K6, given the likelihoods Lp (P,), the rows
// the p-space filter let through (tin, or none) and K4's t, tlc, trc,
// updates each walker p:
//   acc = Lp > Lmin && !done
//   acc: un = u + t v (K4's row, each operation rounded on its own, as
//        K4 rounds it), Ln = Lp, done = 1
//   !acc && !done: tl, tr = tlc, trc (the shrunk bracket)
// and the counters: nc += P, or the rows tin let through (every row,
// done walkers' too, as the JAX package bills them); it += 1. Where
// every walker is done or it reaches max_it, step s ends in the same
// launch:
//   accs[s] = #done / P, one rounded division
//   widths[s] = (w[(P-1)/2] + w[P/2]) * 0.5 over the sorted final
//     brackets w = tr - tl (NaN last, as torch.sort sorts)
//   s += 1, it = 0, and while s < nsteps: u = un, v = dirbank[s], tl,
//     tr = the chord of u + t v through the unit cube (chord.cuh, K5's
//     own), done = 0
// K6 keeps the bank row K4 reads, row = s * max_it + it; past the last
// step it stays at the bank's last row. flag = s >= nsteps. Once s ==
// nsteps a round changes nothing and bills nothing, so rounds queued
// past the end are exact no-ops.
//
// Bound on an H100: bytes, far below a launch. A round reads each
// walker's likelihood, t, shrunk bracket, flag and filter row (about 17
// bytes) and copies an accepted walker's row; a step boundary reads the
// widths and a row of directions and writes u, v and the chord: at P
// 128, d 8 about 6 KB, some nanoseconds at 3.35 TB/s. What sets its time
// is the launch and the chain of dependent steps inside it.
//
// Design: one kernel launch a round, blocks of 1024 threads, in one of
// two forms.
//   single: one block strides over every walker (P * d up to 12800 and
//     P up to 2048: the sync engines' P 64 and 128). It counts the done
//     and billed walkers itself and, where the step ends, ends it.
//   grid: blocks of `chunk` walkers each. Each adds its counts to a
//     64-bit counter beside the state (tick[0]: done << 32 | billed)
//     and, after a __threadfence, takes a ticket (tick[1]); the block
//     that takes the last ticket reads the totals, puts both back to 0
//     for the next round (inside the kernel, so a CUDA graph replays it
//     as it is) and ends the round as the single block does. It reads
//     what the other blocks wrote past L1 (__ldcg).
// A round's time is its chain of dependent loads, so a thread issues
// every load of its first walker (flag, likelihood, filter row, both
// brackets) and of its first coordinate of the accepted rows (u, v, t)
// together with the counters', before it learns whether the round is a
// no-op. A thread takes a walker (acc, its bracket, the counts; in the
// single block its final width's key, into shared memory) and
// coordinates of the accepted rows (un = u + t v, over the flat (P, d)
// range, so that the loads are coalesced and independent); `done` is
// read by both before the block's first barrier and written after it.
// The block's counts come from that barrier itself (__syncthreads_count,
// at most a walker a thread) and its reductions from the warps' redux
// instructions, not from chains of shuffles.
// At a step boundary the median is two order
// statistics of the widths' 32-bit keys (the float's bits mapped so
// that unsigned order is the floats' order, -0 below +0, NaN above
// +inf). Up to P 256 (kRankMax) the keys sit in shared memory and each
// thread counts, for its key, the keys at or below it: the key of rank
// r is the least key whose count exceeds r, so one pass and one
// block-wide min give both statistics, with no atomics. Above it, radix
// selection of the lower one in four passes of 8 bits, each counted in
// a histogram per warp (lanes of one bin agree on one leader by
// __match_any_sync, so no atomics and no contention) and scanned by one
// warp, 8 bins a lane, with shuffles; the upper one is the same key
// where it repeats past the lower rank, else the least key above it.
// Exact selection gives torch.sort's values, so the median is the plain
// version's bits (the one tie left free: a -0 and a +0 width at the
// median rank, which torch.sort may order either way). The next step's
// chords: every thread of the block takes a walker's coordinates in
// groups of g lanes (g the least power of two with g * 8 >= d, at most
// 32), its 8 coordinates' loads issued before any is used, folded
// across the group by shuffles (chord.cuh).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "chord.cuh"

namespace {

using chord_core::chord;
using chord_core::chord_group_fold;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// coordinates a lane loads at once in the chords
constexpr int kCoords = 8;
// form bits of un_sync_update's `form` (-1: chosen from P and d)
constexpr int kFormGrid = 1;
constexpr int kFormRadix = 2;
// the single block up to P * d = kSingleElems and P = kSingleWalkers;
// rank counting up to P = kRankMax, and at most kRankKeys keys. Chosen on
// an H100 (scripts/bench_kernels.py --kernel sync_update): in a CUDA
// graph the single block beat the grid inside a step up to P 256 at d 50
// and P 2048 at d 2 (the grid's ticket costs ~0.002 ms), the grid won
// from P * d 16384; rank counting tied radix selection at P 512 and lost
// at 1024.
constexpr int64_t kSingleElems = 12800;
constexpr int kSingleWalkers = 2048;
constexpr int kRankMax = 256;
constexpr int kRankKeys = 1024;
// coordinates a block of the grid form updates, about
constexpr int kGridElems = 4096;

struct Args {
  const float* Lp;
  const uint8_t* tin;
  const float* ts;
  const float* tlc;
  const float* trc;
  const float* Lmin;
  const float* dirbank;
  int nsteps, max_it, P, d;
  float* u;
  float* v;
  float* tl;
  float* tr;
  float* un;
  float* Ln;
  uint8_t* done;
  int64_t* nc;
  int64_t* s;
  int64_t* it;
  int64_t* row;
  uint8_t* flag;
  float* accs;
  float* widths;
  unsigned long long* tick;   // grid form: done << 32 | billed, ticket;
                              // 0 between rounds
  int chunk;        // walkers a block (grid form)
  int group;        // lanes a walker in the chords
  bool radix;
};

struct Shared {
  unsigned whist[kWarps][256];
  unsigned hist[256];
  __align__(16) unsigned keys[kRankKeys];
  unsigned red[2][kWarps];
  unsigned sel[2];
  unsigned totals[3];
};

// a float's 32-bit key: unsigned order is the floats' order (-0 below
// +0), every NaN above +inf
__device__ __forceinline__ unsigned width_key(float w) {
  if (w != w) return 0xffffffffu;
  const unsigned b = __float_as_uint(w);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_width(unsigned k) {
  if (k == 0xffffffffu) return CUDART_NAN_F;
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// walker p's final bracket width as a key, read past L1: other blocks
// may have written the bracket
__device__ __forceinline__ unsigned width_key_at(const Args& a, int p) {
  return width_key(__fsub_rn(__ldcg(a.tr + p), __ldcg(a.tl + p)));
}

// two values a thread reduced over the block (sum, or min with kMin);
// every thread gets both. red: 2 x 32 words of shared memory.
template <bool kMin>
__device__ __forceinline__ unsigned warp_reduce(unsigned x) {
  return kMin ? __reduce_min_sync(kFull, x) : __reduce_add_sync(kFull, x);
}

template <bool kMin>
__device__ void block_reduce2(unsigned& x, unsigned& y,
                              unsigned (*red)[kWarps]) {
  x = warp_reduce<kMin>(x);
  y = warp_reduce<kMin>(y);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    red[0][threadIdx.x >> 5] = x;
    red[1][threadIdx.x >> 5] = y;
  }
  __syncthreads();
  x = warp_reduce<kMin>(red[0][lane]);
  y = warp_reduce<kMin>(red[1][lane]);
}

// walker p's width key: staged in shared memory, or read
__device__ __forceinline__ unsigned key_of(const Args& a, const Shared& sh,
                                           bool staged, int p) {
  return staged ? sh.keys[p] : width_key_at(a, p);
}

// the key of rank k (0-based) among the P widths: four passes of 8 bits
// from the top, each counting, in one histogram a warp, the keys that
// share the bits chosen so far; warp 0 scans the summed histogram
__device__ unsigned select_key(const Args& a, unsigned k, bool staged,
                               Shared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned* whist = &sh.whist[0][0];
  for (int i = tid; i < kWarps * 256; i += kThreads) whist[i] = 0;
  __syncthreads();
  unsigned prefix = 0, mask = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    // the same trip count on every lane of a warp: the match below needs
    // all of them
    for (int base = warp * 32; base < a.P; base += kThreads) {
      const int p = base + lane;
      unsigned bin = 256;
      if (p < a.P) {
        const unsigned key = key_of(a, sh, staged, p);
        if ((key & mask) == prefix) bin = (key >> shift) & 255u;
      }
      const unsigned peers = __match_any_sync(kFull, bin);
      // one leader a bin: the warp's histogram has one writer an address
      if (bin < 256 && lane == __ffs(peers) - 1)
        sh.whist[warp][bin] += __popc(peers);
    }
    __syncthreads();
    // the warps' histograms summed, and zeroed for the next pass
    for (int b = tid; b < 256; b += kThreads) {
      unsigned c = 0;
      for (int w = 0; w < kWarps; ++w) {
        c += sh.whist[w][b];
        sh.whist[w][b] = 0;
      }
      sh.hist[b] = c;
    }
    __syncthreads();
    if (warp == 0) {
      unsigned c[8], tot = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = sh.hist[lane * 8 + j];
        tot += c[j];
      }
      unsigned incl = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned n = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += n;
      }
      // the lane whose bins hold rank k (k is below the total)
      const int hit = __ffs(__ballot_sync(kFull, k < incl)) - 1;
      if (lane == hit) {
        unsigned kk = k - (incl - tot);
        int b = 0;
        while (b < 7 && kk >= c[b]) kk -= c[b++];
        sh.sel[0] = prefix | (static_cast<unsigned>(lane * 8 + b) << shift);
        sh.sel[1] = kk;
      }
    }
    __syncthreads();
    prefix = sh.sel[0];
    k = sh.sel[1];
    mask |= 255u << shift;
  }
  return prefix;
}

// the keys of ranks (P - 1) / 2 and P / 2 of the P widths (*staged*:
// their keys are in shared memory already)
__device__ void median_keys(const Args& a, bool staged, Shared& sh,
                            unsigned& key1, unsigned& key2) {
  const int tid = threadIdx.x, P = a.P;
  const unsigned k1 = (P - 1) / 2, k2 = P / 2;
  if (!a.radix) {
    // each key's count of keys at or below it: the key of rank r is the
    // least key whose count exceeds r
    if (!staged) {
      for (int p = tid; p < P; p += kThreads)
        sh.keys[p] = width_key_at(a, p);
      __syncthreads();
    }
    unsigned c1 = 0xffffffffu, c2 = 0xffffffffu;
    const uint4* k4 = reinterpret_cast<const uint4*>(sh.keys);
    for (int p = tid; p < P; p += kThreads) {
      const unsigned key = sh.keys[p];
      unsigned le = 0;
      int j = 0;
      for (; j + 4 <= P; j += 4) {
        const uint4 q = k4[j >> 2];
        le += (q.x <= key) + (q.y <= key) + (q.z <= key) + (q.w <= key);
      }
      for (; j < P; ++j) le += sh.keys[j] <= key;
      if (le > k1) c1 = min(c1, key);
      if (le > k2) c2 = min(c2, key);
    }
    block_reduce2<true>(c1, c2, sh.red);
    key1 = c1;
    key2 = c2;
    return;
  }
  key1 = select_key(a, k1, staged, sh);
  key2 = key1;
  if (k2 != k1) {
    unsigned le = 0, above = 0xffffffffu;
    for (int p = tid; p < P; p += kThreads) {
      const unsigned key = key_of(a, sh, staged, p);
      if (key <= key1) ++le;
      else above = min(above, key);
    }
    unsigned zero = 0;
    block_reduce2<false>(le, zero, sh.red);
    block_reduce2<true>(above, zero, sh.red);
    key2 = le > k2 ? key1 : above;
  }
}

// step s ends: its accepting fraction and median final bracket, then
// the next step's start for every walker. Run by one whole block.
__device__ void end_step(const Args& a, int64_t s, unsigned ndone,
                         bool staged, Shared& sh) {
  const int tid = threadIdx.x, P = a.P, d = a.d;
  unsigned key1, key2;
  median_keys(a, staged, sh, key1, key2);
  if (tid == 0) {
    a.accs[s] = __fdiv_rn(static_cast<float>(ndone), static_cast<float>(P));
    a.widths[s] = __fmul_rn(__fadd_rn(key_width(key1), key_width(key2)),
                            0.5f);
  }
  __syncthreads();   // every width is read before the chords overwrite it

  // the next step: every walker from its point, on its next direction
  // and full chord, a group of g lanes a walker, kCoords coordinates a
  // lane at a time
  const int64_t s1 = s + 1;
  if (s1 < a.nsteps) {
    const int g = a.group, gl = tid & (g - 1);
    const float* dn = a.dirbank + s1 * P * static_cast<int64_t>(d);
    // the same trip count on every thread: the fold needs whole warps
    for (int base = 0; base < P; base += kThreads / g) {
      const int p = base + tid / g;
      const int64_t off = static_cast<int64_t>(p) * d;
      float lo = -CUDART_INF_F, hi = CUDART_INF_F;
      for (int k0 = 0; k0 < d; k0 += g * kCoords) {
        float uk[kCoords], vk[kCoords];
#pragma unroll
        for (int j = 0; j < kCoords; ++j) {
          const int k = k0 + gl + j * g;
          uk[j] = vk[j] = 0.0f;
          if (p < P && k < d) {
            uk[j] = __ldcg(a.un + off + k);
            vk[j] = dn[off + k];
          }
        }
#pragma unroll
        for (int j = 0; j < kCoords; ++j) {
          const int k = k0 + gl + j * g;
          if (p < P && k < d) {
            a.u[off + k] = uk[j];
            a.v[off + k] = vk[j];
            chord(uk[j], vk[j], lo, hi);
          }
        }
      }
      chord_group_fold(lo, hi, g);
      if (p < P && gl == 0) {
        a.tl[p] = lo;
        a.tr[p] = hi;
        a.done[p] = 0;
      }
    }
  }
  if (tid == 0) {
    *a.s = s1;
    *a.it = 0;
    *a.row = s1 < a.nsteps ? s1 * a.max_it
                           : static_cast<int64_t>(a.nsteps) * a.max_it - 1;
    *a.flag = s1 >= a.nsteps ? 1 : 0;
  }
}

template <bool kGrid>
__global__ void __launch_bounds__(kThreads)
sync_update_kernel(const Args a) {
  __shared__ Shared sh;
  const int tid = threadIdx.x, d = a.d;
  const int c0 = kGrid ? blockIdx.x * a.chunk : 0;
  const int c1 = kGrid ? min(a.P, c0 + a.chunk) : a.P;
  // the single block keeps its walkers' final widths as keys in shared
  // memory for the median
  const bool stage = !kGrid && a.P <= kRankKeys;
  // every load of the round's first pass at once: the counters, the
  // thread's first walker and its first coordinate. Every thread reads
  // the step and iteration before any block writes them: only the block
  // that ends the round does, after its barriers.
  const int64_t s = *a.s;
  const int64_t it = *a.it + 1;
  const float Lmin = *a.Lmin;
  const int64_t nc = tid == 0 ? *a.nc : 0;
  const int pw = c0 + tid;
  bool was = true, billed = true;
  float L = 0.0f, tl0 = 0.0f, tr0 = 0.0f, tlc0 = 0.0f, trc0 = 0.0f;
  if (pw < c1) {
    was = a.done[pw] != 0;
    L = a.Lp[pw];
    billed = a.tin == nullptr || a.tin[pw] != 0;
    tl0 = a.tl[pw];
    tr0 = a.tr[pw];
    tlc0 = a.tlc[pw];
    trc0 = a.trc[pw];
  }
  int pe = c0 + tid / d, ke = tid % d;
  bool was_e = true;
  float Le = 0.0f, ue = 0.0f, ve = 0.0f, te = 0.0f;
  if (pe < c1) {
    const int64_t i = static_cast<int64_t>(pe) * d + ke;
    was_e = a.done[pe] != 0;
    Le = a.Lp[pe];
    ue = a.u[i];
    ve = a.v[i];
    te = a.ts[pe];
  }
  if (s >= a.nsteps) return;

  // each walker: acc, its likelihood or shrunk bracket, the counts, and
  // (staged) its final width's key; done is written after the barrier
  unsigned ndone = 0, nbill = 0;
  auto walker = [&](int p, bool was_p, float L_p, bool billed_p, float tl_p,
                    float tr_p, float tlc_p, float trc_p) {
    const bool acc = !was_p && L_p > Lmin;
    if (acc) {
      a.Ln[p] = L_p;
    } else if (!was_p) {
      a.tl[p] = tl_p = tlc_p;
      a.tr[p] = tr_p = trc_p;
    }
    ndone += was_p || acc;
    nbill += billed_p;
    if (stage) sh.keys[p] = width_key(__fsub_rn(tr_p, tl_p));
    return acc;
  };
  const bool acc0 = pw < c1 && walker(pw, was, L, billed, tl0, tr0, tlc0,
                                      trc0);
  for (int p = pw + kThreads; p < c1; p += kThreads)
    walker(p, a.done[p] != 0, a.Lp[p], a.tin == nullptr || a.tin[p] != 0,
           a.tl[p], a.tr[p], a.tlc[p], a.trc[p]);
  // the accepted rows, un = u + t v, coordinate by coordinate over the
  // block's walkers
  if (pe < c1 && !was_e && Le > Lmin)
    a.un[static_cast<int64_t>(pe) * d + ke] = __fadd_rn(ue, __fmul_rn(te, ve));
  {
    const int step_p = kThreads / d, step_k = kThreads % d;
#pragma unroll 4
    for (;;) {
      pe += step_p;
      ke += step_k;
      if (ke >= d) {
        ke -= d;
        ++pe;
      }
      if (pe >= c1) break;
      if (a.done[pe] == 0 && a.Lp[pe] > Lmin) {
        const int64_t i = static_cast<int64_t>(pe) * d + ke;
        a.un[i] = __fadd_rn(a.u[i], __fmul_rn(a.ts[pe], a.v[i]));
      }
    }
  }
  if (c1 - c0 <= kThreads) {   // a walker a thread at most
    ndone = __syncthreads_count(ndone);
    nbill = a.tin == nullptr ? c1 - c0 : __syncthreads_count(nbill);
  } else {
    block_reduce2<false>(ndone, nbill, sh.red);
  }
  // done is written once every thread of the block has read it
  if (acc0) a.done[pw] = 1;
  for (int p = pw + kThreads; p < c1; p += kThreads)
    if (a.done[p] == 0 && a.Lp[p] > Lmin) a.done[p] = 1;

  if (kGrid) {
    __threadfence();   // this block's writes before its ticket
    __syncthreads();
    if (tid == 0) {
      atomicAdd(a.tick, (static_cast<unsigned long long>(ndone) << 32)
                        | nbill);
      __threadfence();
      const bool last = atomicAdd(a.tick + 1, 1ull) == gridDim.x - 1;
      sh.totals[2] = last;
      if (last) {
        __threadfence();
        const unsigned long long t = atomicExch(a.tick, 0ull);
        atomicExch(a.tick + 1, 0ull);
        sh.totals[0] = static_cast<unsigned>(t >> 32);
        sh.totals[1] = static_cast<unsigned>(t);
      }
    }
    __syncthreads();
    if (!sh.totals[2]) return;
    ndone = sh.totals[0];
    nbill = sh.totals[1];
  }
  const bool finish = ndone == static_cast<unsigned>(a.P) || it >= a.max_it;
  if (tid == 0) {
    *a.nc = nc + nbill;
    if (!finish) {
      *a.it = it;
      *a.row = s * a.max_it + it;
    }
  }
  if (finish) end_step(a, s, ndone, stage, sh);
}

}  // namespace

// tin: nullptr where every row is billed; tick: 2 words, 0 on entry and
// left at 0. form: -1 chooses the single block or the grid and the rank
// count or radix selection from P and d; else kFormGrid | kFormRadix
// bits (rank counting takes P <= 1024). The caller checks that nsteps,
// max_it, P and d are at least 1, P below 2**24 (the done count and P
// are exact as floats) and P * d below 2**31.
extern "C" int un_sync_update(const float* Lp, const uint8_t* tin,
                              const float* ts, const float* tlc,
                              const float* trc, const float* Lmin,
                              const float* dirbank, int nsteps, int max_it,
                              int P, int d, int form, float* u, float* v,
                              float* tl, float* tr, float* un, float* Ln,
                              uint8_t* done, int64_t* nc, int64_t* s,
                              int64_t* it, int64_t* row, uint8_t* flag,
                              float* accs, float* widths,
                              unsigned long long* tick, void* stream) {
  if (form < 0)
    form = (static_cast<int64_t>(P) * d > kSingleElems || P > kSingleWalkers
                ? kFormGrid : 0)
           | (P > kRankMax ? kFormRadix : 0);
  if (!(form & kFormRadix) && P > kRankKeys)
    return static_cast<int>(cudaErrorInvalidValue);
  int group = 1;
  while (group < 32 && group * kCoords < d) group *= 2;
  int chunk = (kGridElems / d) & ~31;
  chunk = chunk < 32 ? 32 : (chunk > kThreads ? kThreads : chunk);
  const Args a{Lp, tin, ts, tlc, trc, Lmin, dirbank, nsteps, max_it, P, d,
               u, v, tl, tr, un, Ln, done, nc, s, it, row, flag, accs,
               widths, tick, chunk, group, (form & kFormRadix) != 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form & kFormGrid)
    sync_update_kernel<true><<<(P + chunk - 1) / chunk, kThreads, 0, st>>>(a);
  else
    sync_update_kernel<false><<<1, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
