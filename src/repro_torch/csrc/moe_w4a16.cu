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
// What the design does about it (second design; the first unpacked and
//   dequantized the weights through shared memory in a single-stage loop):
//   the dense W4A16 GEMM's loop (w4a16_ring.cuh: the cp.async ring of raw
//   packed bytes, dequantization into the mma.sync fragments, split K where
//   the grid is small), with the expert as part of blockIdx.z, 64-bit
//   per-expert bases and the row counts read on the device: an m-tile
//   wholly past its expert's count writes zeros and returns, with no host
//   sync. No activation quantization: weight-only keeps bf16 activations.
// bf16 x bf16 products are exact in f32, so only the order of the f32 sum
//   differs from the plain version; the ragged entry equals the
//   dense-grouped one bit for bit on zero-filled padding.
#include "w4a16_ring.cuh"

// x (E*C, K) bf16; counts (E,) int32 or null (every row routed); w (E, K/2,
// N) packed int4; s (E, K/gs, N) f32; out (E*C, N) f32; ws (splits, E*C,
// N) f32 when splits > 1 (else unused). All contiguous and 16-byte
// aligned. K % 128 == 0, K % gs == 0, gs % 16 == 0, 1 <= splits <= K / 128,
// E * splits <= 65535; bm is 16 or 64. Returns cudaGetLastError() after
// the launches.
extern "C" int moe_w4a16_launch(const void* x, const void* counts,
                                const void* w, const void* s, void* out,
                                void* ws, int E, int C, int N, int K, int gs,
                                int bm, int splits, void* stream) {
  return w4a16_launch(x, counts, w, s, out, ws, E, C, N, K, gs, bm, splits,
                      stream);
}
