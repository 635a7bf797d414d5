// Staging helpers shared by the cp.async ring kernels (w4a16_ring.cuh,
// w4a8_ring.cuh and, through tc_bf16.cuh, the two flash-attention
// kernels): 16- and 4-byte global -> shared copies, their commit groups and
// waits, the plain-load path for rows that are not 16-byte aligned,
// ldmatrix, the small integer quotient both loops track groups with, and
// the routed-row count of an expert that the grouped launches read on the
// device (also act_quant.cu's routed entry).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !pred
__device__ __forceinline__ void cp16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0));
}
// 4 bytes global -> shared (cp.async.cg takes only 16), zero-filled when
// !pred
__device__ __forceinline__ void cp4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The path for rows that are not 16-byte aligned (N % 16 != 0): the first
// n elements of a 16-byte chunk of T, global -> shared by plain loads, the
// rest of the chunk zero
template <typename T>
__device__ __forceinline__ void copy16_tail(void* dst, const T* src, int n) {
  constexpr int E = 16 / sizeof(T);
  union {
    T e[E];
    int4 v;
  } u;
#pragma unroll
  for (int i = 0; i < E; ++i) u.e[i] = i < n ? src[i] : T(0);
  *reinterpret_cast<int4*>(dst) = u.v;
}

// floor(n / gs) for the quotients here (n < gs + 256, 16 <= gs < 2^20):
// in f32 with a half-unit margin, far above its rounding error
__device__ __forceinline__ int div_small(int n, float inv_gs) {
  return __float2int_rz((static_cast<float>(n) + 0.5f) * inv_gs);
}

// Routed rows of expert e: min(counts[e], C), clamped at 0 (C without
// counts).
__device__ __forceinline__ int routed_rows(const int* counts, int e, int C) {
  if (counts == nullptr) return C;
  const int c = counts[e];
  return c < 0 ? 0 : (c < C ? c : C);
}

// Sets a kernel's dynamic shared memory limit once per device (the
// attribute belongs to the kernel and the device). F is the kernel.
template <typename F>
cudaError_t allow_smem(F* kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

}  // namespace
