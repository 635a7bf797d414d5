// Fine-grained and coarse W4A8 (and W8A8) GEMM with float scales: paper
// Eq. 1, the baseline Integer Scale replaces.
//
//   C_g = C_{g-1} + FLOAT(A_g * W_g) * s_g     (one convert + f32 FMA a group)
//   O   = C_G * s_a
//
// Replaces: src/repro/kernels/w4a8_gemm_fscale.py::fg_gemm_float_scale, the
//   Pallas TPU kernel (_kernel, _group_accumulate(integer=False)), fine
//   (group_size > 0) and coarse (group_size = -1, one scale row: the
//   OdysseyLLM-style per-channel baseline).
// What bounds it on the H100: the same as the IS kernel. At decode (M <= 4)
//   device-memory bytes: the packed weights (K*N/2 bytes) and the f32 group
//   scales (4*K*N/gs bytes, as many as the IS kernel's int32 scales) are
//   read once for a handful of rows. At
//   prefill (M = 128) int8 tensor-core operations and bytes are of the same
//   order.
// What the design does about it: it is the IS kernel's loop (w4a8_tile.cuh)
//   with one change, which is the paper's whole point: at the end of each
//   group the int32 partial is converted with __int2float_rn, multiplied by
//   the f32 group scale and added into an f32 accumulator (explicit _rn
//   intrinsics, no fused multiply-add, so each step rounds as the plain
//   version's product-then-sum does); the epilogue multiplies by s_a. The
//   per-group convert and f32 FMA are the only difference from the IS
//   kernel, so an IS-vs-FS time difference measures them alone.
// Coarse: the wrapper passes gs = K and the single scale row, so the int32
//   partial runs over all of K (|acc| <= K*127*7 for W4, K*127*127 for W8:
//   no overflow at K <= 11008) and the output is (float(acc) * s[n]) *
//   s_a[m], exactly the plain version's arithmetic: bit-exact. Fine: f32
//   group sums in a fixed order where the plain version's torch.sum fixes
//   none, so the two agree to f32 rounding.
#include "w4a8_tile.cuh"  // the loop and the FloatScale policy

// xq (M, K) int8; sa (M,) f32; w (K/2, N) packed int4 (w_bits = 4) or
// (K, N) int8 (w_bits = 8); s (K/gs, N) f32; out (M, N) f32. All
// contiguous, xq 16-byte aligned. K % 128 == 0, K % gs == 0, gs % 32 == 0
// (coarse: gs = K). bm is 16 or 64. Returns cudaGetLastError() after the
// launch.
extern "C" int w4a8_gemm_fs_launch(const void* xq, const void* sa,
                                   const void* w, const void* s, void* out,
                                   int M, int N, int K, int gs, int w_bits,
                                   int bm, void* stream) {
  return w4a8_launch<FloatScale>(xq, sa, w, s, out, M, N, K, gs, w_bits, bm,
                                 stream);
}
