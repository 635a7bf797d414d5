// qlint fixture: an integer dot without an int32 accumulator.
//
// Replaces: src/repro/analysis/fixtures.py::_fx_no_preferred, one of the
//   five kernels the Pallas factory _pallas (fixtures.py:18) wraps.
// Seeded defect (the reference's): the int8 x int8 products are summed in
//   an 8-bit accumulator, which wraps (two's complement) long before the
//   sum is complete. qlint flags it int-dot-preferred-type, from the plain
//   version's int8 mm (torch's CPU mm returns the operands' dtype).
// x (M, K) int8, w (K, N) int8, out (M, N) int8. One block of N threads
//   (the Pallas grid (1,)); thread n sums column n of every row.
#include <cstdint>

#include <cuda_runtime.h>

__global__ void broken_no_preferred_kernel(const int8_t* __restrict__ x,
                                           const int8_t* __restrict__ w,
                                           int8_t* __restrict__ out, int M,
                                           int K, int N) {
  const int n = threadIdx.x;
  for (int m = 0; m < M; ++m) {
    int8_t acc = 0;
    for (int k = 0; k < K; ++k) {
      acc = static_cast<int8_t>(acc + x[m * K + k] * w[k * N + n]);
    }
    out[m * N + n] = acc;
  }
}

// Returns cudaGetLastError() after the launch. N <= 1024.
extern "C" int broken_no_preferred_launch(const void* x, const void* w,
                                          void* out, int M, int K, int N,
                                          void* stream) {
  broken_no_preferred_kernel<<<1, N, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int8_t*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}
