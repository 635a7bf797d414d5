// qlint fixture: a float dot on a path registered as integer-scale.
//
// Replaces: src/repro/analysis/fixtures.py::_fx_fp32_dot, one of the five
//   kernels the Pallas factory _pallas (fixtures.py:18) wraps.
// Seeded defect (the reference's): the int8 operands are converted to f32
//   and multiplied and summed in f32, so there is no int8 MMA on a kernel
//   whose certificate assumes Eq. 2's int32 accumulation. qlint flags it
//   float-accum-on-is-path, from the plain version's float mm and from the
//   PTX (no mma...s32.s8.s8.s32).
// x (M, K) int8, w (K, N) int8, out (M, N) f32. One block of N threads (the
//   Pallas grid (1,) with whole-array blocks); thread n sums column n of
//   every row in k order. A simple kernel: its speed is not the point.
//   |x| <= 127, |w| <= 7 and K <= 2^14 keep every partial sum an integer
//   below 2^24, so the f32 sum is exact in any order.
#include <cstdint>

#include <cuda_runtime.h>

__global__ void broken_fp32_dot_kernel(const int8_t* __restrict__ x,
                                       const int8_t* __restrict__ w,
                                       float* __restrict__ out, int M, int K,
                                       int N) {
  const int n = threadIdx.x;
  for (int m = 0; m < M; ++m) {
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) {
      acc = fmaf(static_cast<float>(x[m * K + k]),
                 static_cast<float>(w[k * N + n]), acc);
    }
    out[m * N + n] = acc;
  }
}

// Returns cudaGetLastError() after the launch. N <= 1024.
extern "C" int broken_fp32_dot_launch(const void* x, const void* w, void* out,
                                      int M, int K, int N, void* stream) {
  broken_fp32_dot_kernel<<<1, N, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<float*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}
