// Per-token symmetric int8 quantization of an (M, K) activation, and of the
// routed rows of a MoE dispatch buffer (the grouped W4A8 GEMMs' input).
//
// Replaces: src/repro/kernels/act_quant.py::act_quant, the Pallas TPU kernel
//   whose block body is _quantize_rows; the routed entry replaces the same
//   body fused into src/repro/kernels/moe_gemm.py::_ragged_kernel (its
//   _quant step), together with that kernel's sa / alpha fold.
// What bounds it on the H100: device-memory bytes. Each element is read once
//   (2 bytes bf16, 4 bytes f32) and one int8 code is written; per element the
//   work is one compare and one divide, far below the card's ridge point.
// What the design does about it: one block per row reads the row with
//   neighbouring threads on neighbouring addresses, reduces |x| to the row's
//   amax (warp shuffles, then one shared-memory step), and walks the row a
//   second time to write the codes; the second pass is served from L1/L2, so
//   device memory sees each byte once. Rows are bound-checked (the TPU kernel
//   padded them with ones instead).
// Bit-exactness with the plain PyTorch version: f32 amax; a true division
//   fmaxf(amax, 1e-8f) / qm; rintf (round half to even, like torch.round and
//   jnp.round) of a true division x / scale; a clamp to +-qm. The library is
//   built without --use_fast_math, which would make '/' approximate. A NaN in
//   the row propagates into the row's scale, as torch.amax does.
// The routed entry (x (E*C, K), row m of expert e routed when
//   m < min(counts[e], C)) runs the same arithmetic with 16-byte loads, once
//   per launch of a grouped GEMM: the row's factor is its scale divided by
//   alpha[e] (__fdiv_rn, the reference's sa / alpha) or the scale itself
//   (float scale: no alpha). An unrouted row reads nothing and gets zero
//   codes and factor 0, so the grouped GEMM sees defined codes whatever the
//   buffer holds past the counts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"  // routed_rows

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// max that propagates NaN (fmaxf drops it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
act_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                 float* __restrict__ scale, int K, float qm) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * K;
  int8_t* qr = q + row * K;

  float amax = 0.f;
  for (int i = threadIdx.x; i < K; i += kThreads) {
    amax = nan_max(amax, fabsf(to_f32(xr[i])));
  }
  for (int off = 16; off > 0; off >>= 1) {
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  __shared__ float warp_max[kThreads / 32];
  __shared__ float row_scale;
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
    for (int w = 1; w < kThreads / 32; ++w) m = nan_max(m, warp_max[w]);
    const float s = (m != m ? m : fmaxf(m, 1e-8f)) / qm;
    row_scale = s;
    scale[row] = s;
  }
  __syncthreads();
  const float s = row_scale;
  for (int i = threadIdx.x; i < K; i += kThreads) {
    const float v = fminf(fmaxf(rintf(to_f32(xr[i]) / s), -qm), qm);
    qr[i] = static_cast<int8_t>(__float2int_rn(v));
  }
}

// One row of the routed buffer per block: row = e * C + m
template <typename T>
__global__ void __launch_bounds__(kThreads)
act_quant_routed_kernel(const T* __restrict__ x, const int* __restrict__ counts,
                        const float* __restrict__ alpha,
                        int8_t* __restrict__ q, float* __restrict__ fac,
                        int C, int K, float qm) {
  constexpr int V = 16 / sizeof(T);  // elements of one 16-byte load
  using Codes = typename std::conditional<V == 8, uint2, uint32_t>::type;
  const int64_t row = blockIdx.x;
  const int e = static_cast<int>(row / C);
  int8_t* qr = q + row * K;
  if (static_cast<int>(row - static_cast<int64_t>(e) * C) >=
      routed_rows(counts, e, C)) {
    for (int i = threadIdx.x * 16; i < K; i += kThreads * 16) {
      *reinterpret_cast<int4*>(qr + i) = make_int4(0, 0, 0, 0);
    }
    if (threadIdx.x == 0) fac[row] = 0.f;
    return;
  }
  const T* xr = x + row * K;

  float amax = 0.f;
  for (int i = threadIdx.x * V; i < K; i += kThreads * V) {
    const int4 raw = *reinterpret_cast<const int4*>(xr + i);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) amax = nan_max(amax, fabsf(to_f32(v[j])));
  }
  for (int off = 16; off > 0; off >>= 1) {
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  __shared__ float warp_max[kThreads / 32];
  __shared__ float row_scale;
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
    for (int w = 1; w < kThreads / 32; ++w) m = nan_max(m, warp_max[w]);
    const float s = (m != m ? m : fmaxf(m, 1e-8f)) / qm;
    row_scale = s;
    fac[row] = alpha != nullptr ? __fdiv_rn(s, alpha[e]) : s;
  }
  __syncthreads();
  const float s = row_scale;
  for (int i = threadIdx.x * V; i < K; i += kThreads * V) {
    const int4 raw = *reinterpret_cast<const int4*>(xr + i);
    const T* v = reinterpret_cast<const T*>(&raw);
    union {
      int8_t c[V];
      Codes w;
    } u;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float c = fminf(fmaxf(rintf(to_f32(v[j]) / s), -qm), qm);
      u.c[j] = static_cast<int8_t>(__float2int_rn(c));
    }
    *reinterpret_cast<Codes*>(qr + i) = u.w;
  }
}

}  // namespace

// x: (M, K) bf16 (x_is_bf16 = 1) or f32, contiguous. q: (M, K) int8.
// scale: (M,) f32. Returns cudaGetLastError() after the launch.
extern "C" int act_quant_launch(const void* x, int x_is_bf16, void* q,
                                void* scale, int M, int K, int qm,
                                void* stream) {
  if (M > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (x_is_bf16) {
      act_quant_kernel<__nv_bfloat16><<<M, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
          static_cast<float*>(scale), K, static_cast<float>(qm));
    } else {
      act_quant_kernel<float><<<M, kThreads, 0, st>>>(
          static_cast<const float*>(x), static_cast<int8_t*>(q),
          static_cast<float*>(scale), K, static_cast<float>(qm));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The routed rows of a grouped launch. x: (E*C, K) bf16 (x_is_bf16 = 1) or
// f32, contiguous and 16-byte aligned, K % 16 == 0; counts (E,) int32 or
// null (every row routed); alpha (E,) f32 or null (the factor is the
// scale). q: (E*C, K) int8; fac: (E*C,) f32. Returns cudaGetLastError()
// after the launch.
extern "C" int act_quant_routed_launch(const void* x, int x_is_bf16,
                                       const void* counts, const void* alpha,
                                       void* q, void* fac, int E, int C,
                                       int K, int qm, void* stream) {
  if (E < 0 || C < 0 || K % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t rows = static_cast<int64_t>(E) * C;
  if (rows > 0 && K > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto* cn = static_cast<const int*>(counts);
    const auto* al = static_cast<const float*>(alpha);
    auto* qo = static_cast<int8_t*>(q);
    auto* fo = static_cast<float*>(fac);
    const unsigned grid = static_cast<unsigned>(rows);
    if (x_is_bf16) {
      act_quant_routed_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), cn, al, qo, fo, C, K,
          static_cast<float>(qm));
    } else {
      act_quant_routed_kernel<float><<<grid, kThreads, 0, st>>>(
          static_cast<const float*>(x), cn, al, qo, fo, C, K,
          static_cast<float>(qm));
    }
  }
  return static_cast<int>(cudaGetLastError());
}
