// Shared core of the radius kernels: K1 (radius_member.cu) and K2
// (bootstrap_radius.cu) use it today; K1t (radius_member_t.cu) can take
// it as it is, because every operand is addressed through two strides.
//
// An operand of points is addressed as base[i * si + k * sk]: point i,
// axis k. Row-major (N, d) operands have si = d, sk = 1; axis-major
// (d, N) operands have si = 1, sk = N.
//
// What the core holds, and why (the card's scarce things at these
// shapes are dependent latency and idle lanes, not bytes or flops):
//
// * Cand<D>: one point's coordinates in registers (D = 4, 8, 16, 32: the
//   axis loop is unrolled over D and skips axes >= d), or, for D = 0, a
//   pointer into shared memory for any larger d. The inner loop then
//   loads only the live point's coordinate.
// * sqdist: the squared distance summed in axis order k = 0..d-1 with
//   the subtract, the multiply and the add each rounded on their own
//   (__fsub_rn / __fmul_rn / __fadd_rn, so nvcc cannot contract them
//   into an FMA): the arithmetic of the plain torch versions and of the
//   reference, so results agree bit for bit.
// * stage_live_tile: a tile of live points into shared memory, valid
//   rows only (squeezed out by a warp ballot and one shared atomicAdd
//   per 32 rows; their order does not matter to an "any"), axis-major
//   [k][row], so that lanes reading neighbouring rows hit 32 banks and
//   the inner loop has no mask load and no branch.
// * group_any_within: a group of G lanes (a power of two, 1..32) shares
//   one candidate; lane g tests rows g, g + G, ..., eight at a time with
//   independent sums so that their separately rounded chains overlap
//   (timed against 2, 4 and 16 rows: 8 is fastest or level everywhere).
//   After each chunk the whole warp votes once (__ballot_sync with the
//   full mask) and the ballot is folded per group. Every lane takes part
//   in every vote, hit or not, until all groups of the warp have a hit
//   or the rows end: the trip count is the same for all lanes, only the
//   arithmetic is predicated.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace member_core {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 8;  // rows a lane tests at a time

template <int D>
struct Cand {
  float c[D];
  __device__ __forceinline__ float get(int k) const { return c[k]; }
  // point j of a global operand; axes >= d and an inactive j read as 0
  __device__ __forceinline__ void load(const float* __restrict__ base,
                                       long long si, long long sk, long long j,
                                       int d, bool active) {
#pragma unroll
    for (int k = 0; k < D; ++k)
      c[k] = (active && k < d) ? base[j * si + k * sk] : 0.0f;
  }
};

template <>
struct Cand<0> {
  const float* p;  // in shared memory
  int step;
  __device__ __forceinline__ float get(int k) const { return p[k * step]; }
};

// squared distances of *c* to R staged points at once, point r's axis k
// at col[r][k * stride]: the axis loop is the outer one, so that the R
// separately rounded chains are independent instructions side by side
template <int D, int R>
__device__ __forceinline__ void sqdist_rows(const Cand<D>& c,
                                            const float* (&col)[R],
                                            int stride, int d,
                                            float (&acc)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
  if constexpr (D > 0) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (k < d) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float diff = __fsub_rn(col[r][k * stride], c.get(k));
          acc[r] = __fadd_rn(acc[r], __fmul_rn(diff, diff));
        }
      }
    }
  } else {
    for (int k = 0; k < d; ++k) {
      const float ck = c.get(k);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float diff = __fsub_rn(col[r][k * stride], ck);
        acc[r] = __fadd_rn(acc[r], __fmul_rn(diff, diff));
      }
    }
  }
}

// squared distance of *c* to one staged point
template <int D>
__device__ __forceinline__ float sqdist(const Cand<D>& c, const float* col,
                                        int stride, int d) {
  const float* cols[1] = {col};
  float acc[1];
  sqdist_rows<D, 1>(c, cols, stride, d, acc);
  return acc[0];
}

// Stage rows [row0, row0 + nrows) of a live set, valid rows only, into
// sh_p[k * stride + pos]. *sh_count must be 0 and visible to the block
// before the call (a __syncthreads() after setting it); after the call
// and another __syncthreads() it holds the number of rows staged. A row
// is valid where its mask is not 0. All threads of the block call this;
// blockDim.x is a multiple of 32.
__device__ __forceinline__ void stage_live_tile(
    const float* __restrict__ tp, long long si, long long sk,
    const int32_t* __restrict__ tmask, int row0, int nrows, int d,
    float* sh_p, int stride, int* sh_count) {
  const int lane = threadIdx.x & 31;
  const int step = static_cast<int>(blockDim.x);
  for (int c0 = static_cast<int>(threadIdx.x) - lane; c0 < nrows;
       c0 += step) {
    const int r = c0 + lane;
    const bool ok = r < nrows && tmask[row0 + r] != 0;
    const unsigned b = __ballot_sync(kFull, ok);
    int base = 0;
    if (lane == 0 && b != 0) base = atomicAdd(sh_count, __popc(b));
    base = __shfl_sync(kFull, base, 0);
    if (ok) {
      const int pos = base + __popc(b & ((1u << lane) - 1u));
      const float* src = tp + static_cast<long long>(row0 + r) * si;
      for (int k = 0; k < d; ++k) sh_p[k * stride + pos] = src[k * sk];
    }
  }
}

// Whether any of the nv staged rows lies within r2 of the group's
// candidate *c*. G lanes (1 << log2g) share the candidate; *hit* comes
// in true for a group that needs no test (no candidate, or a hit in an
// earlier tile) and goes out equal on all lanes of a group. Every lane
// of the warp must call this with the same nv.
template <int D>
__device__ __forceinline__ bool group_any_within(const Cand<D>& c, int d,
                                                 const float* sh_p,
                                                 int stride, int nv,
                                                 int log2g, float r2,
                                                 bool hit) {
  const int G = 1 << log2g;
  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1);
  const int gbase = lane - g;
  // one bit at the first lane of every group
  const unsigned basemask = G == 32 ? 1u : kFull / ((1u << G) - 1u);
  for (int base = 0; base < nv; base += G * kRows) {
    if (!hit) {
      bool found = false;
      const float* cols[kRows];
      bool in[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = base + r * G + g;
        in[r] = i < nv;
        cols[r] = sh_p + (in[r] ? i : 0);
      }
      float acc[kRows];
      sqdist_rows<D, kRows>(c, cols, stride, d, acc);
#pragma unroll
      for (int r = 0; r < kRows; ++r) found = found || (in[r] && acc[r] <= r2);
      hit = found;
    }
    // fold the ballot: bit gbase gathers the lanes gbase .. gbase + G - 1
    unsigned x = __ballot_sync(kFull, hit);
    for (int s = 1; s < G; s <<= 1) x |= x >> s;
    hit = (x >> gbase) & 1u;
    if ((x & basemask) == basemask) break;
  }
  return hit;
}

}  // namespace member_core
