// qlint fixture: an m-tile index map off by one.
//
// Replaces: src/repro/analysis/fixtures.py::_fx_index_map, one of the five
//   kernels the Pallas factory _pallas (fixtures.py:18) wraps.
// Seeded defect (the reference's): output m-tile i reads input m-tile
//   i + 1, so the last tile's block starts past the end of x. qlint flags
//   it index-map-bounds from the launch plan. As Pallas pads blocks, the
//   caller passes x padded to the grid's full reach ((M + BM) rows), so
//   the launch reads the pad and never leaves the buffer.
// x (M + BM, K) int8 (M declared), out (M, K) int8. M / BM blocks (the
//   Pallas grid (M / BM,)) of 256 threads; block i copies one (BM, K) tile.
#include <cstdint>

#include <cuda_runtime.h>

constexpr int BM = 4;  // rows of an m-tile

__global__ void broken_index_map_kernel(const int8_t* __restrict__ x,
                                        int8_t* __restrict__ out, int K) {
  const int i = blockIdx.x;
  for (int r = 0; r < BM; ++r) {
    for (int c = threadIdx.x; c < K; c += blockDim.x) {
      out[(i * BM + r) * K + c] = x[((i + 1) * BM + r) * K + c];
    }
  }
}

// Returns cudaGetLastError() after the launch. M % BM == 0.
extern "C" int broken_index_map_launch(const void* x, void* out, int M, int K,
                                       void* stream) {
  broken_index_map_kernel<<<M / BM, 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(out), K);
  return static_cast<int>(cudaGetLastError());
}
