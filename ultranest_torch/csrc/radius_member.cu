// K1: MLFriends radius membership of proposal candidates.
//
// Replaces the Pallas kernel ultranest_tpu/ops/pallas_kernels.py
// (_member_kernel / _radius_member_call, reached from
// fused._radius_member): for each candidate, is any valid live point
// within squared radius r2? Operands are row-major: live points
// (N, d), candidates (M, d).
//
// Bound on an H100: arithmetic. A candidate outside needs its distance
// to every valid live point (3 d operations and a compare each), one
// inside at least one; the inputs are a few MB and stay in L2. At the
// shapes the region path gives it (a few hundred live points, 4096 to
// 131072 candidates) the kernel is far from that bound for another
// reason: one thread walking all live rows alone is one long dependent
// chain, and 4096 such threads leave most of the card empty.
// Design: the kernel body is csrc/member_kernel.cuh (shared with K1t,
// which gives it axis-major operands), built on csrc/member_core.cuh:
// G lanes share a candidate (chosen by the caller from M so that a
// launch puts about 65536 threads on the card: 16 at M 4096, 1 at
// M 131072), the candidate sits in registers (d <= 32) or in shared
// memory, the live set is staged compacted and axis-major, and the warp
// votes once per chunk of rows.
//
// Arithmetic: acc += diff * diff in axis order k = 0..d-1, the
// subtract, multiply and add each rounded on their own. That is the
// arithmetic of the plain torch version and of the reference, so
// membership agrees bit for bit, boundary rows included. A NaN
// candidate is no member (no acc <= r2 holds). A live row is valid
// where its mask is not 0.
#include "member_kernel.cuh"

// group: lanes per candidate, a power of two from 1 to 32
extern "C" int un_radius_member(const float* tpoints, const int32_t* tmask,
                                int npts, const float* cands, int m, int d,
                                float r2, int group, int32_t* out,
                                void* stream) {
  return dispatch<false>(tpoints, tmask, npts, cands, m, d, r2, group, out,
                         stream);
}
