// qlint fixture: the int32 accumulator squeezed through int16.
//
// Replaces: src/repro/analysis/fixtures.py::_fx_narrowing, one of the five
//   kernels the Pallas factory _pallas (fixtures.py:18) wraps.
// Seeded defect (the reference's): the int32 sum of the int8 products goes
//   through int16_t before the store. At K = 256, |x| <= 127 and |w| <= 7,
//   |acc| reaches 256 * 127 * 7 = 227584, past int16. qlint flags it
//   narrowing-convert, from the plain version's int32 -> int16 convert and
//   from the PTX (a 16-bit convert on the accumulator chain).
// x (M, K) int8, w (K, N) int8, out (M, N) int32. One block of N threads
//   (the Pallas grid (1,)); thread n sums column n of every row.
#include <cstdint>

#include <cuda_runtime.h>

__global__ void broken_narrowing_kernel(const int8_t* __restrict__ x,
                                        const int8_t* __restrict__ w,
                                        int32_t* __restrict__ out, int M,
                                        int K, int N) {
  const int n = threadIdx.x;
  for (int m = 0; m < M; ++m) {
    int32_t acc = 0;
    for (int k = 0; k < K; ++k) {
      acc += static_cast<int32_t>(x[m * K + k]) *
             static_cast<int32_t>(w[k * N + n]);
    }
    out[m * N + n] = static_cast<int32_t>(static_cast<int16_t>(acc));
  }
}

// Returns cudaGetLastError() after the launch. N <= 1024.
extern "C" int broken_narrowing_launch(const void* x, const void* w, void* out,
                                       int M, int K, int N, void* stream) {
  broken_narrowing_kernel<<<1, N, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}
