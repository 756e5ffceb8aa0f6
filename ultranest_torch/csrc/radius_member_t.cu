// K1t: MLFriends radius membership on transposed operands.
//
// Replaces the Pallas kernel evaluate/bench_pallas_membership.py
// (_member_kernel_t / pallas_member_t), the transposed-layout variant of
// K1: for each candidate j, is any valid live point i (tm[i] > 0) within
// squared radius r2? Live points arrive as tp_t (d, N) and candidates as
// cd_t (d, M), each axis a contiguous row.
//
// Bound on an H100: arithmetic, as K1 (a candidate outside needs
// N x (3 d + 1) operations, one inside at least 3 d + 1; the inputs
// stay in L2). Far from it for K1's reason: dependent latency and idle
// lanes. Design: K1's kernel body (csrc/member_kernel.cuh on
// csrc/member_core.cuh) instantiated for axis-major operands, point i's
// axis k at base[k * N + i] with 64-bit offsets: G lanes share a
// candidate (the caller's choice, as K1: about 65536 threads a launch),
// the candidate sits in registers (d <= 32) or in the block's shared
// memory (larger d), the valid live rows are staged compacted, and the
// warp votes once per chunk of rows.
//
// What the layout buys: with one lane a candidate a warp's loads of one
// candidate axis are 32 neighbouring floats (row-major K1 strides them
// by d), and so are its loads of one axis of 32 live rows when staging
// the tile. With G lanes a candidate the G lanes read one address and
// the warp 32 / G neighbouring ones. Both loads happen once per block,
// outside the row loop, so the layout shows only where that loop is
// short. Measured beside K1 on an H100 (80GB HBM3, 700 W), device-only
// ms at the candidates' median nearest distance, (N, M, d): (512, 4096,
// 16), G 16: 0.0147, K1 0.0176 (a block stages 32 KB of live rows for
// 16 candidates, and K1's staging lanes stride by d); (512, 32768, 2),
// G 2: 0.0214, K1 0.0207; (1024, 16384, 8), G 4: 0.0515, K1 0.0496.
// The one-thread-a-candidate kernel this replaced took 0.1465, 0.0756
// and 0.2245 (scripts/bench_kernels.py --kernel radius_member_t).
//
// Arithmetic: acc += diff * diff in axis order k = 0..d-1, the subtract,
// multiply and add each rounded on their own (__fsub_rn / __fmul_rn /
// __fadd_rn, so nvcc cannot contract them into an FMA): the arithmetic
// of K1, of the plain torch version and of the reference, so membership
// agrees bit for bit, boundary candidates included. A live row is valid
// where its mask is above 0: a negative entry is an invalid row.
#include "member_kernel.cuh"

// group: lanes per candidate, a power of two from 1 to 32
extern "C" int un_radius_member_t(const float* tp_t, const int32_t* tm,
                                  int npts, const float* cd_t, int m, int d,
                                  float r2, int group, int32_t* out,
                                  void* stream) {
  return dispatch<true>(tp_t, tm, npts, cd_t, m, d, r2, group, out, stream);
}
