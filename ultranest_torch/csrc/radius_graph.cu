// K8: the transform layer's two radius graphs.
//
// Replaces no Pallas kernel: the JAX package builds these graphs with
// XLA and on the host (ultranest_tpu/ops/cluster.py:37-118,
// connected_components and label_propagation_components, and
// ultranest_tpu/ops/pairwise.py:243, subtract_nearby). The port ran
// them as host numpy (two dense N x N distance matrices, scipy's CSR
// and union-find, a Python loop over the labels) in every MLFriends
// region rebuild; at 400 to 900 live points that was four fifths of
// the rebuild. Here both graphs are one call on the card:
// * labels[i]: the smallest index of the component of i in the graph
//   of the t-space points (whitened) whose pairs lie within r2, the
//   canonical form of connected_components;
// * centred[i] (where u-points are given): u[i] minus the mean of the
//   u-points within r2 of it, itself included (count at least 1), as
//   subtract_nearby.
// A distance is the separately rounded subtract, multiply and add in
// axis order (csrc/member_core.cuh, sqdist), and a pair is adjacent
// where it is <= r2 in float32: the t-space adjacency equals the port's
// torch route (pairwise_sqdist(...) <= float32(r2)) bit for bit, so the
// labels equal label_propagation_components' on any device.
//
// Bound on an H100: at the rebuilds' shapes (N 400 to 900, d 2) the
// work is about 1.5 N^2 distances of 3 d + 1 operations, 7.8e6 at N
// 864: 0.12 us at 67 TFLOP/s. The kernel is bound by latency instead:
// the union-find's dependent reads of the parent array, and the launch
// itself (about 0.02-0.03 ms of device time at these shapes).
// Design, two kernels on the stream:
// * init_kernel sets parent[i] = i and the blocks' tick to 0.
// * graph_kernel: every block stages all N points, axis-major ([k][j],
//   neighbouring j on neighbouring banks), of both sets in shared memory
//   (8 N d bytes: the cap MAX_GRAPH_ELEMS on N d keeps that at 96 KB,
//   and d <= 32 keeps a row's coordinates and sums in registers, Cand<D>
//   with D = 4, 8, 16, 32). A warp owns row i, its lanes columns j,
//   j + 32, ... Each edge (i, j) with j < i (the graph is symmetric, so
//   each once) goes into a per-warp queue in shared memory by ballot,
//   and every 32 queued edges the lanes unite one each: a row's unions
//   take one round of dependent reads per 32 edges, not one per column
//   chunk. The union-find lives in device memory (parent, volatile
//   reads, path halving by plain stores, which only ever point a node
//   at another of its ancestors) and hooks the larger root under the
//   smaller with atomicCAS: the root of a component can only be its
//   smallest index, whatever the order of the unions, so the labels do
//   not depend on scheduling. The u-space neighbours' sums and count
//   are per lane, then summed over the warp by a butterfly: a fixed
//   order, so centred is the same on every run (numpy's and torch's
//   matrix products sum in other orders: a few ulp apart).
//   The last block to finish (a tick counter, behind a fence in every
//   thread) writes labels[i] = find(i) for all i.
#include <cuda_runtime.h>
#include <stdint.h>

#include "member_core.cuh"

namespace {

using member_core::Cand;
using member_core::kFull;

constexpr int kWarps = 8;
constexpr int kMaxBlocks = 264;  // two blocks on each of the 132 SMs
// the largest d of the instantiations below (Cand<32>); the route's cap
// on N d is kernels.MAX_GRAPH_ELEMS alone, and a staging beyond the
// card's shared memory is refused by the runtime (launch, below)
constexpr int kMaxDim = 32;

__global__ void init_kernel(int n, int* __restrict__ parent,
                            unsigned int* __restrict__ tick) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) parent[i] = i;
  if (i == 0) *tick = 0u;
}

// the root of x; halves the path on the way (a node's parent only ever
// moves to one of its ancestors, so a store that races another is safe)
__device__ __forceinline__ int find_root(volatile int* parent, int x) {
  while (true) {
    const int y = parent[x];
    if (y == x) return x;
    const int z = parent[y];
    if (z == y) return y;
    parent[x] = z;
    x = z;
  }
}

// joins the components of a and b: the larger root goes under the
// smaller, so that a component's root is its smallest index
__device__ __forceinline__ void unite(volatile int* parent, int a, int b) {
  while (true) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    if (atomicCAS(const_cast<int*>(parent) + a, a, b) == a) return;
  }
}

// the second launch bound lets ptxas take the registers D = 32 needs (a
// row's coordinates in both spaces and its sums: 96 and more); without
// it, it aims for 128 and spills
template <int D, bool CENTRE>
__global__ void __launch_bounds__(32 * kWarps, 1)
    graph_kernel(const float* __restrict__ tp, const float* __restrict__ up,
                 int n, int d, float r2, int* parent,
                 unsigned int* __restrict__ tick, int* __restrict__ labels,
                 float* __restrict__ centred) {
  extern __shared__ float sh[];
  __shared__ int queue[kWarps][64];
  __shared__ bool last;
  float* sh_t = sh;  // [k][j]
  float* sh_u = sh + static_cast<size_t>(d) * n;
  for (int e = threadIdx.x; e < n * d; e += blockDim.x) {
    const int j = e / d;
    const int k = e - j * d;
    sh_t[k * n + j] = tp[e];
    if constexpr (CENTRE) sh_u[k * n + j] = up[e];
  }
  __syncthreads();
  volatile int* vp = parent;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* q = queue[warp];
  for (int i = blockIdx.x * kWarps + warp; i < n; i += gridDim.x * kWarps) {
    Cand<D> ti;
    ti.load(sh_t, 1, n, i, d, true);
    Cand<D> ui;
    float acc[D];
    int cnt = 0;
    if constexpr (CENTRE) {
      ui.load(sh_u, 1, n, i, d, true);
#pragma unroll
      for (int k = 0; k < D; ++k) acc[k] = 0.0f;
    }
    int qn = 0;  // the same on every lane
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      const bool edge =
          j < i && member_core::sqdist(ti, sh_t + j, n, d) <= r2;
      const unsigned int m = __ballot_sync(kFull, edge);
      if (edge) q[qn + __popc(m & ((1u << lane) - 1u))] = j;
      qn += __popc(m);
      __syncwarp();
      if (qn >= 32) {
        qn -= 32;
        unite(vp, i, q[qn + lane]);
        __syncwarp();
      }
      if constexpr (CENTRE) {
        if (j < n && member_core::sqdist(ui, sh_u + j, n, d) <= r2) {
          ++cnt;
#pragma unroll
          for (int k = 0; k < D; ++k)
            if (k < d) acc[k] = __fadd_rn(acc[k], sh_u[k * n + j]);
        }
      }
    }
    if (lane < qn) unite(vp, i, q[lane]);
    __syncwarp();
    if constexpr (CENTRE) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        cnt += __shfl_xor_sync(kFull, cnt, off);
#pragma unroll
        for (int k = 0; k < D; ++k)
          if (k < d)
            acc[k] = __fadd_rn(acc[k], __shfl_xor_sync(kFull, acc[k], off));
      }
      if (lane == 0) {
        const float c = static_cast<float>(cnt > 1 ? cnt : 1);
#pragma unroll
        for (int k = 0; k < D; ++k)
          if (k < d)
            centred[static_cast<size_t>(i) * d + k] =
                __fsub_rn(ui.get(k), __fdiv_rn(acc[k], c));
      }
    }
  }
  // every thread's unions are visible before the block counts itself
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tick, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    labels[i] = find_root(vp, i);
}

template <int D, bool CENTRE>
int launch(const float* tp, const float* up, int n, int d, float r2,
           int* parent, unsigned int* tick, int* labels, float* centred,
           cudaStream_t s) {
  const size_t smem =
      static_cast<size_t>(CENTRE ? 2 : 1) * n * d * sizeof(float);
  // above 48 KB with the static queue: the limit raised for the launch
  // (an error beyond the card's opt-in limit, 227 KB on an H100)
  if (smem + sizeof(int) * kWarps * 64 + 16 > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        graph_kernel<D, CENTRE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int blocks = (n + kWarps - 1) / kWarps;
  blocks = blocks > kMaxBlocks ? kMaxBlocks : blocks;
  graph_kernel<D, CENTRE><<<blocks, 32 * kWarps, smem, s>>>(
      tp, up, n, d, r2, parent, tick, labels, centred);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const float* tp, const float* up, int n, int d, float r2,
             int* parent, unsigned int* tick, int* labels, float* centred,
             cudaStream_t s) {
  if (up != nullptr)
    return launch<D, true>(tp, up, n, d, r2, parent, tick, labels, centred,
                           s);
  return launch<D, false>(tp, up, n, d, r2, parent, tick, labels, centred,
                          s);
}

}  // namespace

// tp, up: (n, d) float32, up null for labels alone; scratch: n + 1
// ints (the parent array and the blocks' tick); out: n ints of labels,
// then, with up, the (n, d) float32 centred points
extern "C" int un_radius_graph(const float* tp, const float* up, int n, int d,
                               float r2, int* scratch, int* out,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || d < 1 || d > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  int* parent = scratch;
  unsigned int* tick = reinterpret_cast<unsigned int*>(scratch + n);
  float* centred = reinterpret_cast<float*>(out + n);
  init_kernel<<<(n + 255) / 256, 256, 0, s>>>(n, parent, tick);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d <= 4)
    return launch_d<4>(tp, up, n, d, r2, parent, tick, out, centred, s);
  if (d <= 8)
    return launch_d<8>(tp, up, n, d, r2, parent, tick, out, centred, s);
  if (d <= 16)
    return launch_d<16>(tp, up, n, d, r2, parent, tick, out, centred, s);
  return launch_d<32>(tp, up, n, d, r2, parent, tick, out, centred, s);
}
