// What the W4A8 / W8A8 GEMM loops share: the int8 tensor-core MMA and the
// Scale policies of Integer Scale (paper Eq. 2) and float scale (Eq. 1).
// The loop of every W4A8 GEMM, dense and grouped (w4a8_ring.cuh), takes a
// policy, so IS and FS differ only in what happens when a quantization
// group ends and in the epilogue.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------------
// Scale policies: Scale::Acc / Scale::Value are the accumulator and
// group-scale types, Scale::group(acc, part, s) folds one group's int32
// partial into the accumulator, Scale::out(acc, fac) is the epilogue.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int wrap_mad(int acc, int a, int b) {
  return static_cast<int>(static_cast<unsigned>(acc) +
                          static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// Eq. 2: the group step in int32 (two's complement wrap like the
// reference's int32; the quantizer caps alpha so it never wraps), one
// I32 -> F32 convert in the epilogue.
struct IntegerScale {
  using Acc = int;
  using Value = int;
  __device__ static __forceinline__ int group(int acc, int part, int s) {
    return wrap_mad(acc, part, s);
  }
  __device__ static __forceinline__ float out(int acc, float fac) {
    return __int2float_rn(acc) * fac;
  }
};

// Eq. 1: the group step is an I32 -> F32 convert, multiply, add (explicit
// _rn intrinsics, no fused multiply-add, so each step rounds as the plain
// version's product-then-sum does).
struct FloatScale {
  using Acc = float;
  using Value = float;
  __device__ static __forceinline__ float group(float acc, int part, float s) {
    return __fadd_rn(acc, __fmul_rn(__int2float_rn(part), s));
  }
  __device__ static __forceinline__ float out(float acc, float fac) {
    return __fmul_rn(acc, fac);
  }
};

}  // namespace
