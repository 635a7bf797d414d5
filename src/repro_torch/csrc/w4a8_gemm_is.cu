// Fine-grained W4A8 (and W8A8) GEMM with Integer Scale: paper Eq. 2.
//
//   C_g = A_g * W_g * s_g^INT + C_{g-1}     (all INT32)
//   O   = FLOAT(C_G) * (s_a / alpha)        (ONE convert per output)
//
// Replaces: src/repro/kernels/w4a8_gemm.py::fg_gemm_integer_scale, the
//   Pallas TPU kernel (_kernel, _group_accumulate(integer=True),
//   _unpack_wblock).
// What bounds it on the H100: at decode (M <= 4) device-memory bytes, since
//   the packed weights (K*N/2 bytes) are read once for a handful of rows; at
//   prefill (M = 128) the int8 tensor-core operations and the bytes are of
//   the same order (about 6 us each for a 4096 x 11008 layer at the card's
//   peaks).
// What the design does about it: the tile loop of w4a8_tile.cuh (int8
//   tensor-core MMAs one quantization group at a time into a per-group
//   int32 partial, weights unpacked in shared memory); at the end of each
//   group the partial is multiplied by the int32 group scale and added into
//   an int32 accumulator in registers. There is no float in the loop, which
//   is the paper's point; the epilogue is one convert times s_a / alpha.
//   No wgmma or TMA yet: a simple kernel that is right comes first.
// Integer sums do not depend on order, so the output is bit-identical to the
//   plain PyTorch version. Integer arithmetic wraps (two's complement) like
//   the reference's int32; the quantizer caps alpha so it never does.
#include "w4a8_tile.cuh"  // the loop and the IntegerScale policy

// xq (M, K) int8; fac (M,) f32 = s_a / alpha; w (K/2, N) packed int4
// (w_bits = 4) or (K, N) int8 (w_bits = 8); s (K/gs, N) int32; out (M, N)
// f32. All contiguous, xq 16-byte aligned. K % 128 == 0, K % gs == 0,
// gs % 32 == 0. bm is 16 or 64. Returns cudaGetLastError() after the launch.
extern "C" int w4a8_gemm_is_launch(const void* xq, const void* fac,
                                   const void* w, const void* s, void* out,
                                   int M, int N, int K, int gs, int w_bits,
                                   int bm, void* stream) {
  return w4a8_launch<IntegerScale>(xq, fac, w, s, out, M, N, K, gs, w_bits,
                                   bm, stream);
}
