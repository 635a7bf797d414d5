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
// What bounds it on the H100: the same as the IS kernel (device-memory
//   bytes at decode: the packed weights and the f32 group scales, as many
//   bytes as the IS kernel's int32 scales; at prefill int8 tensor-core
//   operations and bytes of the same order).
// What the design does about it: it is the IS kernel's loop (w4a8_ring.cuh)
//   with one change, which is the paper's whole point: at the end of each
//   group the int32 partial is converted with __int2float_rn, multiplied by
//   the f32 group scale and added into an f32 accumulator (explicit _rn
//   intrinsics, no fused multiply-add, so each step rounds as the plain
//   version's product-then-sum does); the epilogue multiplies by s_a. The
//   per-group convert and f32 FMA are the only difference from the IS
//   kernel, so an IS-vs-FS time difference measures them alone.
// Coarse: the wrapper passes gs = K and the single scale row; the int32
//   partials of all of K (|P| <= K*127*128 for W4 and W8: no overflow at
//   K <= 65536) are summed over the k-halves and the K splits before the
//   one group step, so the output is (float(P) * s[n]) * s_a[m], exactly
//   the plain version's arithmetic: bit-exact. Fine: f32 group sums in a
//   fixed order where the plain version's torch.sum fixes none, so the two
//   agree to f32 rounding.
#include "w4a8_ring.cuh"

// xq (M, K) int8; sa (M,) f32; w (K/2, N) packed int4 (w_bits = 4) or
// (K, N) int8 (w_bits = 8); s (K/gs, N) f32; out (M, N) f32; ws (splits,
// M, N) of 4-byte elements (f32 fine, int32 coarse) when splits > 1 (else
// unused). All contiguous and 16-byte aligned. K % 128 == 0, K % gs == 0,
// gs % 32 == 0, gs <= 65536 (coarse: gs = K), 1 <= splits <= K / 128; bm is
// 16 or 64. Returns cudaGetLastError() after the launches.
extern "C" int w4a8_gemm_fs_launch(const void* xq, const void* sa,
                                   const void* w, const void* s, void* out,
                                   void* ws, int M, int N, int K, int gs,
                                   int w_bits, int bm, int splits,
                                   void* stream) {
  // one expert of M rows, every row routed
  return w4a8_ring_launch<FloatScale, false>(
      xq, sa, nullptr, nullptr, w, s, out, ws, 1, M, N, K, gs, w_bits, bm,
      splits, stream);
}
