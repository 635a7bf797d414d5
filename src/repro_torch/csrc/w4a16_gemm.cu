// Fine-grained W4A16 weight-only GEMM: the Marlin analog the paper compares
// against.
//
//   O = X_bf16 @ bf16(W_int4 * s_g)     (f32 accumulation over all of K)
//
// Replaces: src/repro/kernels/w4a16_gemm.py::w4a16_gemm, the Pallas TPU
//   kernel (_kernel, _dequant_group_accumulate, _unpack_wblock).
// What bounds it on the H100, and what the design does about it: see
//   w4a16_ring.cuh, the loop this entry point shares with the grouped
//   kernel (moe_w4a16.cu): split K on packing-unit boundaries with a
//   fixed-order reduction, a 4-stage cp.async ring of the raw packed bytes,
//   dequantization straight into the mma.sync fragments. Here it runs as
//   one expert whose capacity is M, with no counts.
#include "w4a16_ring.cuh"

// x (M, K) bf16; w (K/2, N) packed int4; s (K/gs, N) f32; out (M, N) f32;
// ws (splits, M, N) f32 when splits > 1 (else unused). All contiguous and
// 16-byte aligned. K % 128 == 0, K % gs == 0, gs % 16 == 0, any N >= 1,
// 1 <= splits <= K / 128; bm is 16 or 64. Launches the tile kernel
// and, when splits > 1, the fixed-order reduction of the splits into out.
// Returns cudaGetLastError() after the launches.
extern "C" int w4a16_gemm_launch(const void* x, const void* w, const void* s,
                                 void* out, void* ws, int M, int N, int K,
                                 int gs, int bm, int splits, void* stream) {
  return w4a16_launch(x, nullptr, w, s, out, ws, 1, M, N, K, gs, bm, splits,
                      stream);
}
