// The chord of a walker's line u + t v through the unit cube, shared by
// K5 (spec_update.cu) and K6 (sync_update.cu), and the NaN-propagating
// max and min it folds with, across a warp (K5) or a group of lanes (K6).
//
// As the plain versions' cube_intersection (ultranest_torch/ops/
// kernels.py): per axis with v != 0, a = (0 - u) / v and b = (1 - u) / v,
// each operation rounded on its own (so a zero u gives the signed zero
// of 0 / v); an axis with v == 0 (either zero) gives a = -inf, b = +inf;
// tl = max over axes of min(a, b), tr = min over axes of max(a, b), NaN
// propagating as torch.minimum, torch.maximum, amax and amin propagate
// it. The one thing left to order: where the extreme is a zero reached
// with both signs on two axes (a walker exactly on a cube corner), a
// fold may keep either sign, as torch's reductions may.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace chord_core {

// torch.maximum / torch.minimum: a NaN operand wins; a tie keeps a
__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b > a ? b : a;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

// fold one axis of the chord of u + t v through the unit cube into
// (lo, hi)
__device__ __forceinline__ void chord(float uk, float vk, float& lo,
                                      float& hi) {
  float a = -CUDART_INF_F, b = CUDART_INF_F;
  if (vk != 0.0f) {
    a = __fdiv_rn(__fsub_rn(0.0f, uk), vk);
    b = __fdiv_rn(__fsub_rn(1.0f, uk), vk);
  }
  lo = max_nan(lo, min_nan(a, b));
  hi = min_nan(hi, max_nan(a, b));
}

// the chord's (lo, hi) folded across aligned groups of g lanes (g a power
// of two up to 32), each lane having folded its own axes; every lane of a
// group gets its group's result. Every lane of the warp must call it.
__device__ __forceinline__ void chord_group_fold(float& lo, float& hi,
                                                 int g) {
  for (int o = g >> 1; o > 0; o >>= 1) {
    lo = max_nan(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = min_nan(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

// the same across the 32 lanes of a warp
__device__ __forceinline__ void chord_warp_fold(float& lo, float& hi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = max_nan(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = min_nan(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

}  // namespace chord_core
