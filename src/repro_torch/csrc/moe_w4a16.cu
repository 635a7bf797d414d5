// Ragged batched-expert W4A16 weight-only GEMM (the Marlin analog) for
// every expert of a MoE layer in one launch.
//
//   per expert e, routed row m < min(counts[e], C):
//   O = X_bf16 @ bf16(W_int4[e] * s_g[e])      (f32 accumulation over K)
//   rows at or past the count: exact zeros
//
// Replaces: src/repro/kernels/moe_gemm.py::grouped_w4a16_gemm_ragged
//   (_ragged_wo_kernel, with counts) and ::grouped_w4a16_gemm
//   (_grouped_wo_kernel, counts null), the Pallas TPU kernels.
// What bounds it on the H100: at Mixtral's decode (C = 8) device-memory
//   bytes: each routed expert's packed int4 weights (K*N/2 bytes) and f32
//   group scales, a quarter of its bf16 weight's bytes; at the 128-token
//   prefill (C = 40) bf16 tensor-core operations and bytes of the same
//   order.
// What the design does about it: the first dense W4A16 design's loop
//   (w4a16_tile.cuh: int4 unpack and bit-identical bf16 dequantization in
//   shared memory, mma.sync m16n8k16 bf16 with f32 accumulation), with the
//   expert as blockIdx.z, 64-bit per-expert bases and the row counts read
//   on the device: an m-tile wholly past its expert's count writes zeros
//   and returns, with no host sync. No activation quantization: weight-only
//   keeps bf16 activations. No wgmma or TMA yet: a simple kernel that is
//   right comes first.
// bf16 x bf16 products are exact in f32, so only the order of the f32 sum
//   differs from the plain version; the ragged entry equals the
//   dense-grouped one bit for bit on zero-filled padding.
#include "w4a16_tile.cuh"

// x (E*C, K) bf16, 16-byte aligned; counts (E,) int32 or null (every row
// routed); w (E, K/2, N) packed int4; s (E, K/gs, N) f32; out (E*C, N) f32.
// All contiguous. K % 128 == 0, K % gs == 0, gs % 16 == 0. bm is 16 or 64.
// Returns cudaGetLastError() after the launch.
extern "C" int moe_w4a16_launch(const void* x, const void* counts,
                                const void* w, const void* s, void* out,
                                int E, int C, int N, int K, int gs, int bm,
                                void* stream) {
  const WoArgs a{static_cast<const __nv_bfloat16*>(x),
                 static_cast<const int8_t*>(w), static_cast<const float*>(s),
                 static_cast<float*>(out), static_cast<const int*>(counts), C,
                 N, K, gs};
  return w4a16_launch(a, E, bm, stream);
}
