// Ragged batched-expert W4A8 (and W8A8) GEMM with Integer Scale: paper
// Eq. 2 for every expert of a MoE layer in one launch.
//
//   per expert e, routed row m < min(counts[e], C):
//   C_g = A_g * W_g[e] * s_g^INT[e] + C_{g-1}        (all INT32)
//   O   = FLOAT(C_G) * (s_a / alpha[e])              (ONE convert)
//   rows at or past the count: exact +0.0
//
// Replaces: src/repro/kernels/moe_gemm.py::_ragged_a8_call via
//   fg_grouped_gemm_integer_scale_ragged (_ragged_kernel, integer=True;
//   raw activations) and ::fg_grouped_gemm_integer_scale (_grouped_kernel,
//   integer=True; pre-quantized codes with sa, no counts), the Pallas TPU
//   kernels.
// What bounds it on the H100: device-memory bytes at both of Mixtral's
//   capacities. At the 4-slot decode (C = 8) each routed expert's packed
//   weights (K*N/2 bytes, 29 MB at 4096 x 14336) and int32 group scales
//   (4*K*N/128) are read once for a handful of rows: about 65 us for seven
//   routed experts at 3.35 TB/s. At the 128-token prefill (C = 40) the
//   int8 operations of the routed rows are about a tenth of that byte time.
//   Experts with no routed row cost nothing but their zero writes.
// What the design does about it (second design; the first quantized the
//   activations again in every n-block and unpacked the weights through
//   shared memory in a single-stage loop, w4a8_tile.cuh):
//   - The routed rows are quantized before the GEMM by act_quant.cu's
//     routed entry (act_quant's arithmetic, so the codes equal the unfused
//     act_quant's bit for bit), once for every grouped GEMM that reads the
//     same dispatch buffer (gate and up). The epilogue divides by alpha:
//     s_a / alpha[e], an IEEE division, then ONE multiply (the reference's
//     op order), so two expert stacks with different amplifiers share one
//     quantization. At the down projection (K = 14336) the first design
//     read and quantized each routed bf16 row in all 64 n-blocks.
//   - The GEMM is the dense IS kernel's loop (w4a8_ring.cuh: a 4-stage
//     cp.async ring of the raw packed bytes, the int8 MMA operands built in
//     registers, split K where the grid would not fill the card) with the
//     expert in blockIdx.z and folded into 32-bit row indices, compiled
//     in (GROUPED) where the dense GEMMs compile it away. The row tile is 16
//     at C = 8 and 64 at C = 40, so each routed expert's weights are read
//     once; the experts count as blocks, so both shapes run unsplit (224 or
//     64 n-blocks times 8 experts).
//   - The counts stay on the device: each block reads counts[e], and an
//     m-tile wholly past it writes zeros and returns, so the ragged
//     skipping costs no host sync and a decode step captures as a CUDA
//     graph.
// Integer sums do not depend on order (mod 2^32, at every split), so the
//   output is bit-identical to the plain PyTorch version, and the ragged
//   entry equals the dense-grouped one on zero-filled padding: both launch
//   this kernel on the same codes and scales.
#include "w4a8_ring.cuh"

// xq (E*C, K) int8 codes; sa (E*C,) f32 (0 past the counts); alpha (E,)
// f32; counts (E,) int32 or null (every row routed); w (E, K/2, N)
// packed int4 (w_bits 4) or (E, K, N) int8 (w_bits 8); s (E, K/gs, N)
// int32; out (E*C, N) f32; ws (splits, E*C, N) int32 when splits > 1
// (else unused). All contiguous and 16-byte aligned. K % 128 == 0,
// K % gs == 0, gs % 32 == 0, gs <= 65536, 1 <= splits <= K / 128,
// E * splits <= 65535, E * C < 2^31; bm is 16 or 64. Returns
// cudaGetLastError() after the launches.
extern "C" int moe_w4a8_is_launch(const void* xq, const void* sa,
                                  const void* alpha, const void* counts,
                                  const void* w, const void* s, void* out,
                                  void* ws, int E, int C, int N, int K,
                                  int gs, int w_bits, int bm, int splits,
                                  void* stream) {
  return w4a8_ring_launch<IntegerScale, true>(
      xq, sa, alpha, counts, w, s, out, ws, E, C, N, K, gs, w_bits, bm,
      splits, stream);
}
