// Fine-grained W4A16 weight-only GEMM: the Marlin analog the paper compares
// against.
//
//   O = X_bf16 @ bf16(W_int4 * s_g)     (f32 accumulation over all of K)
//
// Replaces: src/repro/kernels/w4a16_gemm.py::w4a16_gemm, the Pallas TPU
//   kernel (_kernel, _dequant_group_accumulate, _unpack_wblock).
// What bounds it on the H100: at decode (M <= 4) device-memory bytes: the
//   packed int4 weights (K*N/2 bytes) and f32 group scales are read once for
//   a handful of rows, a quarter of a bf16 weight's bytes. That is Marlin's
//   case and the reason weight-only quantization exists. At prefill
//   (M = 128) bf16 tensor-core operations and bytes are of the same order.
// What the design does about it: the tile loop of w4a16_tile.cuh: per
//   128-row packing unit, the bf16 activations are copied to shared memory
//   with 16-byte loads, and the packed int4 weights are unpacked and
//   dequantized as __float2bfloat16_rn(float(w) * s[g, n]) into shared
//   memory (round-to-nearest-even, as the plain version's .to(bfloat16) is,
//   so the dequantized weights are bit-identical to it); bf16 tensor-core
//   MMAs (mma.sync m16n8k16, f32 accumulate) then run over the whole K with
//   no per-group epilogue. The tile is BM x 64 outputs, BM = 16 for decode
//   and 64 for prefill, as in the W4A8 kernels. No wgmma or TMA yet: a
//   simple kernel that is right comes first.
// bf16 x bf16 products are exact in f32, so only the order of the f32 sum
//   differs from the plain version.
#include "w4a16_tile.cuh"

// x (M, K) bf16, 16-byte aligned; w (K/2, N) packed int4; s (K/gs, N) f32;
// out (M, N) f32. All contiguous. K % 128 == 0, K % gs == 0, gs % 16 == 0.
// bm is 16 or 64. Returns cudaGetLastError() after the launch.
extern "C" int w4a16_gemm_launch(const void* x, const void* w, const void* s,
                                 void* out, int M, int N, int K, int gs,
                                 int bm, void* stream) {
  const WoArgs a{static_cast<const __nv_bfloat16*>(x),
                 static_cast<const int8_t*>(w), static_cast<const float*>(s),
                 static_cast<float*>(out), nullptr, M, N, K, gs};
  return w4a16_launch(a, 1, bm, stream);
}
