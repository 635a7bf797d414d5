// Ragged batched-expert W4A8 (and W8A8) GEMM with float scales: paper
// Eq. 1, fine and coarse, for every expert of a MoE layer in one launch,
// with the activation quantization fused. The baseline that
// moe_w4a8_is.cu's Integer Scale replaces.
//
//   per expert e, routed row m < min(counts[e], C):
//   C_g = C_{g-1} + FLOAT(A_g * W_g[e]) * s_g[e]   (one convert + f32 FMA a group)
//   O   = C_G * s_a
//   rows at or past the count: exact zeros
//
// Replaces: src/repro/kernels/moe_gemm.py::_ragged_a8_call via
//   fg_grouped_gemm_float_scale_ragged (_ragged_kernel, integer=False; raw
//   activations, x_kind 1/2) and ::fg_grouped_gemm_float_scale
//   (_grouped_kernel, integer=False; pre-quantized codes with sa, x_kind
//   0), the Pallas TPU kernels; fine (group_size > 0) and coarse
//   (group_size = -1: the wrapper passes gs = K and one scale row).
// What bounds it on the H100: as moe_w4a8_is.cu: device-memory bytes of
//   the routed experts' packed weights and f32 scales at decode; int8
//   tensor-core operations and bytes of the same order at the prefill.
// What the design does about it: the IS kernel's loop (w4a8_tile.cuh) with
//   the FloatScale policy in place of IntegerScale, which is the paper's
//   whole point: the two grouped kernels differ only in the group step and
//   the epilogue, as the dense pair does. Expert index, 64-bit bases,
//   device-side counts, the skipped m-tiles and the fused per-token
//   quantization are those of moe_w4a8_is.cu. No alpha: Eq. 1 has none.
// Coarse is bit-identical to the plain version (one int32 sum over all of
//   K, |acc| <= K*127*127 < 2^31 for K <= 14336, then the same two
//   multiplies); fine sums its f32 group terms in a fixed order where the
//   plain version's torch.sum fixes none, so the two agree to f32 rounding.
//   The ragged entry equals the dense-grouped one bit for bit on
//   zero-filled padding (the same loop over the same codes).
#include "w4a8_tile.cuh"

// x (E*C, K): int8 codes (x_kind 0, with fac (E*C,) f32 = s_a) or raw bf16
// (1) / f32 (2) rows, 16-byte aligned; counts (E,) int32 or null (every row
// routed); w (E, K/2, N) packed int4 (w_bits 4) or (E, K, N) int8
// (w_bits 8); s (E, K/gs, N) f32 (coarse: gs = K, one row); out (E*C, N)
// f32. All contiguous. K % 128 == 0, K % gs == 0, gs % 32 == 0. bm is 16 or
// 64; qm the largest activation code. Returns cudaGetLastError() after the
// launch.
extern "C" int moe_w4a8_fs_launch(const void* x, int x_kind, const void* fac,
                                  const void* counts, const void* w,
                                  const void* s, void* out, int E, int C,
                                  int N, int K, int gs, int w_bits, int bm,
                                  float qm, void* stream) {
  return w4a8_grouped_launch<FloatScale>(x, x_kind, fac, nullptr, counts, w,
                                         s, out, E, C, N, K, gs, w_bits, bm,
                                         qm, stream);
}
