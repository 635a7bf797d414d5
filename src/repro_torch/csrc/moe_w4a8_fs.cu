// Ragged batched-expert W4A8 (and W8A8) GEMM with float scales: paper
// Eq. 1, fine and coarse, for every expert of a MoE layer in one launch.
// The baseline that moe_w4a8_is.cu's Integer Scale replaces.
//
//   per expert e, routed row m < min(counts[e], C):
//   C_g = C_{g-1} + FLOAT(A_g * W_g[e]) * s_g[e]  (a convert + f32 FMA a group)
//   O   = C_G * s_a
//   rows at or past the count: exact +0.0
//
// Replaces: src/repro/kernels/moe_gemm.py::_ragged_a8_call via
//   fg_grouped_gemm_float_scale_ragged (_ragged_kernel, integer=False; raw
//   activations) and ::fg_grouped_gemm_float_scale (_grouped_kernel,
//   integer=False; pre-quantized codes with sa), the Pallas TPU kernels;
//   fine (group_size > 0) and coarse (group_size = -1: the wrapper passes
//   gs = K and one scale row).
// What bounds it on the H100: as moe_w4a8_is.cu: device-memory bytes of
//   the routed experts' packed weights and f32 scales at C = 8 and at
//   C = 40 (there the routed rows' int8 operations take about a tenth of
//   the byte time); coarse reads one scale row an expert instead of K/128.
// What the design does about it: the IS kernel's design (moe_w4a8_is.cu:
//   the routed rows quantized once by act_quant.cu's routed entry, then
//   the loop of w4a8_ring.cuh with the expert in blockIdx.z
//   and the counts read on the device) with the FloatScale policy in place
//   of IntegerScale, which is the paper's whole point: the two grouped
//   kernels differ only in the group step and the epilogue, as the dense
//   pair does, so an IS-vs-FS time difference measures the group step
//   alone (paper §5.5 on Mixtral). No alpha: Eq. 1 has none, so the factor
//   is s_a itself.
// Coarse is bit-identical to the plain version at every split (one int32
//   sum over all of K, |acc| <= K*127*128 < 2^31 for K <= 65536, summed
//   over the k-halves and the splits before the same two multiplies); fine
//   sums its f32 group terms in a fixed order where the plain version's
//   torch.sum fixes none, so the two agree to f32 rounding. The ragged
//   entry equals the dense-grouped one bit for bit on zero-filled padding
//   (the same loop over the same codes).
#include "w4a8_ring.cuh"

// xq (E*C, K) int8 codes; sa (E*C,) f32 (0 past the counts); counts (E,)
// int32 or null (every row routed); w (E, K/2, N) packed int4 (w_bits 4) or
// (E, K, N) int8 (w_bits 8); s (E, K/gs, N) f32 (coarse: gs = K, one row);
// out (E*C, N) f32; ws (splits, E*C, N) of 4-byte elements (f32 fine,
// int32 coarse) when splits > 1 (else unused). All contiguous and 16-byte
// aligned. K % 128 == 0, K % gs == 0, gs % 32 == 0, gs <= 65536 (coarse:
// gs = K), 1 <= splits <= K / 128, E * splits <= 65535, E * C < 2^31; bm
// is 16 or 64. Returns cudaGetLastError() after the launches.
extern "C" int moe_w4a8_fs_launch(const void* xq, const void* sa,
                                  const void* counts, const void* w,
                                  const void* s, void* out, void* ws, int E,
                                  int C, int N, int K, int gs, int w_bits,
                                  int bm, int splits, void* stream) {
  return w4a8_ring_launch<FloatScale, true>(
      xq, sa, nullptr, counts, w, s, out, ws, E, C, N, K, gs, w_bits, bm,
      splits, stream);
}
