// Ragged batched-expert W4A8 (and W8A8) GEMM with Integer Scale: paper
// Eq. 2 for every expert of a MoE layer in one launch, with the activation
// quantization fused.
//
//   per expert e, routed row m < min(counts[e], C):
//   C_g = A_g * W_g[e] * s_g^INT[e] + C_{g-1}        (all INT32)
//   O   = FLOAT(C_G) * (s_a / alpha[e])              (ONE convert)
//   rows at or past the count: exact zeros
//
// Replaces: src/repro/kernels/moe_gemm.py::_ragged_a8_call via
//   fg_grouped_gemm_integer_scale_ragged (_ragged_kernel, integer=True;
//   raw activations, x_kind 1/2) and ::fg_grouped_gemm_integer_scale
//   (_grouped_kernel, integer=True; pre-quantized codes with sa, x_kind 0,
//   no counts), the Pallas TPU kernels.
// What bounds it on the H100: at Mixtral's decode (C = 8 rows an expert)
//   device-memory bytes: each routed expert's packed weights (K*N/2 bytes)
//   and int32 group scales (4*K*N/128) are read once for a handful of rows;
//   experts with no routed row cost nothing but their zero writes. At the
//   128-token prefill (C = 40) int8 tensor-core operations and the bytes
//   are of the same order.
// What the design does about it: the dense IS kernel's tile loop
//   (w4a8_tile.cuh, the IntegerScale policy), with the expert as
//   blockIdx.z and 64-bit per-expert bases. The row counts stay on the
//   device: each block reads counts[e], and an m-tile wholly past it writes
//   zeros and returns, so the ragged skipping costs no host sync and a
//   decode step stays capturable as a CUDA graph. The TPU kernel quantizes
//   a whole (bm, K) slab into VMEM; here K = 14336 would not fit a block's
//   shared memory, so each block first takes its rows' amax in one pass
//   over K and then quantizes each 128-wide chunk as it stages it (the
//   ActRaw policy), with act_quant.cu's arithmetic: the codes equal the
//   unfused act_quant's bit for bit. No wgmma or TMA yet: a simple kernel
//   that is right comes first.
// Integer sums do not depend on order, and the epilogue divides sa by
//   alpha[e] (IEEE, as torch's tensor division) before one multiply, so the
//   output is bit-identical to the plain PyTorch version, and the ragged
//   entry equals the dense-grouped one on zero-filled padding.
#include "w4a8_tile.cuh"

// x (E*C, K): int8 codes (x_kind 0, with fac (E*C,) f32 = s_a) or raw bf16
// (1) / f32 (2) rows, 16-byte aligned; alpha (E,) f32; counts (E,) int32 or
// null (every row routed); w (E, K/2, N) packed int4 (w_bits 4) or
// (E, K, N) int8 (w_bits 8); s (E, K/gs, N) int32; out (E*C, N) f32. All
// contiguous. K % 128 == 0, K % gs == 0, gs % 32 == 0. bm is 16 or 64; qm
// the largest activation code. Returns cudaGetLastError() after the launch.
extern "C" int moe_w4a8_is_launch(const void* x, int x_kind, const void* fac,
                                  const void* alpha, const void* counts,
                                  const void* w, const void* s, void* out,
                                  int E, int C, int N, int K, int gs,
                                  int w_bits, int bm, float qm,
                                  void* stream) {
  if (alpha == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return w4a8_grouped_launch<IntegerScale>(x, x_kind, fac, alpha, counts, w,
                                           s, out, E, C, N, K, gs, w_bits,
                                           bm, qm, stream);
}
