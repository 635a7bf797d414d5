// Fine-grained W4A8 (and W8A8) GEMM with Integer Scale: paper Eq. 2.
//
//   C_g = A_g * W_g * s_g^INT + C_{g-1}     (all INT32)
//   O   = FLOAT(C_G) * (s_a / alpha)        (ONE convert per output)
//
// Replaces: src/repro/kernels/w4a8_gemm.py::fg_gemm_integer_scale, the
//   Pallas TPU kernel (_kernel, _group_accumulate(integer=True),
//   _unpack_wblock).
// What bounds it on the H100, and what the design does about it: see
//   w4a8_ring.cuh, the loop this kernel shares with the float-scale GEMM
//   (split K with a fixed-order reduction, a 4-stage cp.async ring of the
//   raw packed bytes, the int8 MMA operands built in registers). Under the
//   IntegerScale policy the end of each group multiplies the int32 partial
//   by the int32 group scale and adds it into an int32 accumulator in
//   registers: there is no float in the loop, which is the paper's point;
//   the epilogue forms s_a / alpha (one IEEE division a row, from the
//   activation scales and the layer's amplifier on the device) and is one
//   convert times it, so the codes of one act_quant launch serve every
//   linear that reads the same activation.
// Integer sums do not depend on order, so the output is bit-identical to the
//   plain PyTorch version at every split count. Integer arithmetic wraps
//   (two's complement) like the reference's int32; the quantizer caps alpha
//   so it never does.
#include "w4a8_ring.cuh"

// xq (M, K) int8; sa (M,) f32; alpha (1,) f32; w (K/2, N) packed int4
// (w_bits = 4) or (K, N) int8 (w_bits = 8); s (K/gs, N) int32; out (M, N)
// f32; ws (splits, M, N) int32 when splits > 1 (else unused). All
// contiguous and 16-byte aligned. K % 128 == 0, K % gs == 0, gs % 32 == 0,
// gs <= 65536, 1 <= splits <= K / 128; bm is 16 or 64. Returns
// cudaGetLastError() after the launches.
extern "C" int w4a8_gemm_is_launch(const void* xq, const void* sa,
                                   const void* alpha, const void* w,
                                   const void* s, void* out, void* ws, int M,
                                   int N, int K, int gs, int w_bits, int bm,
                                   int splits, void* stream) {
  // one expert of M rows, every row routed
  return w4a8_ring_launch<IntegerScale, false>(
      xq, sa, alpha, nullptr, w, s, out, ws, 1, M, N, K, gs, w_bits, bm,
      splits, stream);
}
