// qlint fixture: a column block that does not divide its operand.
//
// Replaces: src/repro/analysis/fixtures.py::_fx_divisibility, one of the
//   five kernels the Pallas factory _pallas (fixtures.py:18) wraps.
// Seeded defect (the reference's): 128-wide column blocks over N = 192
//   with no tail guard, so the last block copies 64 columns past the
//   declared extent. qlint flags it blockspec-divisibility from the launch
//   plan. As Pallas pads blocks, the caller passes both operands padded to
//   the grid's full reach (row stride ld = cdiv(N, BN) * BN), so the launch
//   stays inside its buffers.
// x (M, ld) int8, out (M, ld) int8 (N columns declared). cdiv(N, BN)
//   blocks of BN threads; thread c of block j copies column j * BN + c.
#include <cstdint>

#include <cuda_runtime.h>

constexpr int BN = 128;  // columns of a block

__global__ void broken_divisibility_kernel(const int8_t* __restrict__ x,
                                           int8_t* __restrict__ out, int M,
                                           int ld) {
  const int c = blockIdx.x * BN + threadIdx.x;  // no c < N guard
  for (int r = 0; r < M; ++r) out[r * ld + c] = x[r * ld + c];
}

// Returns cudaGetLastError() after the launch.
extern "C" int broken_divisibility_launch(const void* x, void* out, int M,
                                          int N, int ld, void* stream) {
  broken_divisibility_kernel<<<(N + BN - 1) / BN, BN, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(out), M, ld);
  return static_cast<int>(cudaGetLastError());
}
