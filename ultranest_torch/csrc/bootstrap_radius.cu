// K2: bootstrapped MLFriends radius.
//
// Replaces the Pallas kernel ultranest_tpu/ops/pallas_kernels.py
// (_bootstrap_kernel / _bootstrap_radius_call, reached from
// ops/bootstrap._bootstrap_radius): over B rounds of selection masks,
// the largest squared distance from a valid unselected live point to
// its nearest selected one.
//
// Bound on an H100: arithmetic. Each pair (i, j) that some round needs
// (i selected, j valid and unselected) costs 3 d operations once, then
// one min per round that needs it, and one max per (round, unselected
// j). At the region rebuilds' shapes (100 to 2048 points, 30 rounds)
// the kernel is far from that bound for other reasons: dependent
// latency and idle lanes. The Pallas kernel computes the N x N matrix
// once in VMEM and reduces all rounds over it; here no matrix is
// stored, but each distance is still computed once.
// Design, two kernels on the stream:
// * The rounds become bits. selbits_kernel writes, for each live row i,
//   one 32-bit word per 32 rounds with bit b set where round b selected
//   i (B is any number: 50 rounds are two words), and sets the result
//   to 0.0, the value the reference's scan carry starts from
//   (ops/bootstrap.py:104-114).
// * radius_kernel: one warp owns column j, lane g takes rows g, g + 32,
//   ...; the column's coordinates sit in registers (instantiated for
//   d <= 4, 8, 16, 32 with the axis loop unrolled; any larger d reads
//   them from shared memory). The live points are staged axis-major
//   ([k][i]: neighbouring rows, 32 banks) with the rows' words. A pair's
//   distance is computed once and then lowers mind[b] for every round b
//   whose bit is set in the row's word and clear in the column's, the
//   32 (or 64) minima in registers, unrolled and predicated. The warp
//   merges each round's minima with __reduce_min_sync on the uint bits
//   (non-negative floats order as unsigned integers; a sum of squares
//   is never -0.0). Column j counts in round b only where valid[j] and
//   bit b of its word is clear. The block's maximum goes out by one
//   atomicMax on the float's bits. Blocks have 1 to 8 warps, npad / 32:
//   128 points give 32 blocks of 4 warps, 2048 points 256 of 8 (timed
//   against npad / 64, / 128 and / 256: more warps share a block's
//   staging, and at these sizes that counts for more than more blocks).
// Arithmetic as in K1 (csrc/member_core.cuh): separately rounded
// subtract, multiply and add in axis order, the sentinel 1e30, and min
// and max, which are exact in any order: the result equals the plain
// torch version's bit for bit, whatever the split.
#include <cuda_runtime.h>
#include <stdint.h>

#include "member_core.cuh"

namespace {

using member_core::Cand;
using member_core::kFull;

constexpr int kMaxWarps = 8;
constexpr float kBig = 1e30f;
constexpr int kTileBytes = 100 * 1024;  // staged rows (two blocks an SM)

__global__ void selbits_kernel(const uint8_t* __restrict__ masks, int npad,
                               int nrounds, int nwords,
                               uint32_t* __restrict__ selbits,
                               float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) *out = 0.0f;
  if (i >= npad) return;
  for (int w = 0; w < nwords; ++w) {
    uint32_t word = 0;
    const int nb = min(32, nrounds - 32 * w);
    for (int b = 0; b < nb; ++b)
      if (masks[static_cast<size_t>(32 * w + b) * npad + i] != 0)
        word |= 1u << b;
    selbits[static_cast<size_t>(w) * npad + i] = word;
  }
}

// NW: words of rounds whose minima a lane holds at once (32 NW
// registers). The second launch bound lets ptxas take the registers it
// needs (96 to 160); without it, it aims for 64 or 128 and spills.
template <int D, int NW>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
    radius_kernel(const float* __restrict__ tpoints,
                  const uint8_t* __restrict__ valid,
                  const uint32_t* __restrict__ selbits, int npad, int d,
                  int nrounds, int nwords, int tile,
                  unsigned int* __restrict__ out) {
  extern __shared__ float sh[];
  __shared__ unsigned int sh_max[kMaxWarps];
  float* sh_p = sh;  // [d][tile]
  uint32_t* sh_s =
      reinterpret_cast<uint32_t*>(sh + static_cast<size_t>(d) * tile);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int j = blockIdx.x * nwarps + warp;
  const bool live = j < npad && valid[j] != 0;
  Cand<D> c;
  if constexpr (D > 0) {
    c.load(tpoints, d, 1, j, d, live);
  } else {
    // the columns of the block's warps, [warp][k]; a warp reads back
    // only what it wrote itself
    float* sh_c =
        reinterpret_cast<float*>(sh_s + static_cast<size_t>(nwords) * tile);
    if (live)
      for (int k = lane; k < d; k += 32)
        sh_c[warp * d + k] = tpoints[static_cast<size_t>(j) * d + k];
    __syncwarp();
    c.p = sh_c + warp * d;
    c.step = 1;
  }
  const bool one_tile = tile >= npad;
  unsigned int colmax = 0;  // the bits of 0.0f
  for (int w0 = 0; w0 < nwords; w0 += NW) {
    // the rounds of these words in which column j counts
    uint32_t need[NW];
    bool any_need = false;
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      need[q] = 0;
      if (live && w0 + q < nwords) {
        const int nb = nrounds - 32 * (w0 + q);
        const uint32_t rounds = nb >= 32 ? kFull : (1u << nb) - 1u;
        need[q] = ~selbits[static_cast<size_t>(w0 + q) * npad + j] & rounds;
      }
      any_need = any_need || need[q] != 0;
    }
    float mind[32 * NW];
#pragma unroll
    for (int b = 0; b < 32 * NW; ++b) mind[b] = kBig;
    for (int row0 = 0; row0 < npad; row0 += tile) {
      const int nt = min(tile, npad - row0);
      if (!one_tile || w0 == 0) {
        __syncthreads();  // the tile before this one has been read
        for (int i = threadIdx.x; i < nt; i += blockDim.x) {
          const float* src = tpoints + static_cast<size_t>(row0 + i) * d;
          for (int k = 0; k < d; ++k) sh_p[k * tile + i] = src[k];
          for (int w = 0; w < nwords; ++w)
            sh_s[w * tile + i] =
                selbits[static_cast<size_t>(w) * npad + row0 + i];
        }
        __syncthreads();
      }
      if (!any_need) continue;
#pragma unroll 2
      for (int i = lane; i < nt; i += 32) {
        uint32_t s[NW];
        uint32_t any = 0;
#pragma unroll
        for (int q = 0; q < NW; ++q) {
          s[q] = w0 + q < nwords ? sh_s[(w0 + q) * tile + i] & need[q] : 0;
          any |= s[q];
        }
        if (any == 0) continue;
        const float acc = member_core::sqdist(c, sh_p + i, tile, d);
#pragma unroll
        for (int q = 0; q < NW; ++q) {
#pragma unroll
          for (int b = 0; b < 32; ++b)
            if (s[q] & (1u << b))
              mind[32 * q + b] = fminf(mind[32 * q + b], acc);
        }
      }
    }
    if (any_need) {  // the same on all lanes of the warp
#pragma unroll
      for (int q = 0; q < NW; ++q) {
#pragma unroll
        for (int b = 0; b < 32; ++b) {
          const unsigned int u =
              __reduce_min_sync(kFull, __float_as_uint(mind[32 * q + b]));
          if (need[q] & (1u << b)) colmax = max(colmax, u);
        }
      }
    }
  }
  if (lane == 0) sh_max[warp] = colmax;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < nwarps; ++w) colmax = max(colmax, sh_max[w]);
    if (colmax > 0) atomicMax(out, colmax);
  }
}

template <int D, int NW>
int launch(const float* tpoints, const uint8_t* valid,
           const uint32_t* selbits, int npad, int nrounds, int nwords, int d,
           float* out, cudaStream_t s) {
  int warps = npad / 32;
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  while (warps & (warps - 1)) warps &= warps - 1;  // a power of two
  const size_t col_bytes =
      D > 0 ? 0 : static_cast<size_t>(warps) * d * sizeof(float);
  const size_t per_row = (static_cast<size_t>(d) + nwords) * sizeof(float);
  if (col_bytes + per_row > 200 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t tile = kTileBytes / per_row;
  tile = tile < 1 ? 1 : (tile > static_cast<size_t>(npad) ? npad : tile);
  const size_t smem = tile * per_row + col_bytes;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        radius_kernel<D, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  radius_kernel<D, NW><<<(npad + warps - 1) / warps, 32 * warps, smem, s>>>(
      tpoints, valid, selbits, npad, d, nrounds, nwords,
      static_cast<int>(tile), reinterpret_cast<unsigned int*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_words(const float* tpoints, const uint8_t* valid,
                 const uint32_t* selbits, int npad, int nrounds, int nwords,
                 int d, float* out, cudaStream_t s) {
  if (nwords == 1)
    return launch<D, 1>(tpoints, valid, selbits, npad, nrounds, nwords, d,
                        out, s);
  return launch<D, 2>(tpoints, valid, selbits, npad, nrounds, nwords, d, out,
                      s);
}

}  // namespace

// selbits: scratch of ceil(nrounds / 32) * npad 32-bit words
extern "C" int un_bootstrap_radius(const float* tpoints, const uint8_t* valid,
                                   const uint8_t* masks, int npad,
                                   int nrounds, int d, uint32_t* selbits,
                                   float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nwords = nrounds > 0 ? (nrounds + 31) / 32 : 0;
  const int blocks = npad > 0 ? (npad + 255) / 256 : 1;
  selbits_kernel<<<blocks, 256, 0, s>>>(masks, npad > 0 ? npad : 0, nrounds,
                                        nwords, selbits, out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nrounds <= 0 || npad <= 0 || d < 1)
    return static_cast<int>(err);
  if (d <= 4)
    return launch_words<4>(tpoints, valid, selbits, npad, nrounds, nwords, d,
                           out, s);
  if (d <= 8)
    return launch_words<8>(tpoints, valid, selbits, npad, nrounds, nwords, d,
                           out, s);
  if (d <= 16)
    return launch_words<16>(tpoints, valid, selbits, npad, nrounds, nwords, d,
                            out, s);
  if (d <= 32)
    return launch_words<32>(tpoints, valid, selbits, npad, nrounds, nwords,
                            d, out, s);
  return launch_words<0>(tpoints, valid, selbits, npad, nrounds, nwords, d,
                         out, s);
}
