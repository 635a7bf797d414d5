// bf16 tensor-core helpers shared by the flash-attention forward
// (flash_attention.cu), its backward (flash_attention_bwd.cu) and the
// W4A16 loop (w4a16_ring.cuh): the transposing ldmatrix, mma.sync
// m16n8k16 (bf16 in, f32 accumulate), f32 pairs packed to bf16 pairs
// (whole, or split into hi and lo parts), and the flash kernels' log2
// constants. The staging helpers (cp16, cp4, commit, wait, ldmatrix_x4,
// smem_addr) are cp_async.cuh's.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ void ldmatrix_x4_t(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b: a the m16 x k16 A fragment, (b0, b1) the k16 x n8 B fragment
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (a, b) as bf16 pairs hi = bf16(a, b) and lo = bf16(a - hi, b - hi):
// hi + lo is within 2^-16 of (a, b), relative
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - __uint_as_float(hi << 16),
                 b - __uint_as_float(hi & 0xffff0000u));
}

}  // namespace
