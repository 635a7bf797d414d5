// Per-token symmetric int8 quantization of an (M, K) activation, and of the
// routed rows of a MoE dispatch buffer (the grouped W4A8 GEMMs' input).
//
// Replaces: src/repro/kernels/act_quant.py::act_quant, the Pallas TPU kernel
//   whose block body is _quantize_rows; the routed entry replaces the same
//   body fused into src/repro/kernels/moe_gemm.py::_ragged_kernel (its
//   _quant step). The reference's sa / alpha fold is not here: the W4A8
//   GEMMs divide by alpha in their epilogue (w4a8_ring.cuh), so one
//   quantization serves every GEMM that reads the same activation.
// What bounds it on the H100: device-memory bytes. Each element is read once
//   (2 bytes bf16, 4 bytes f32) and one int8 code is written; per element the
//   work is one compare and one divide, far below the card's ridge point. At
//   decode (4 rows) the bytes take about 10 ns, below any launch: there the
//   latency of one pass over a row is the cost, and the callers launch it
//   once per distinct activation (kernels/ops.py quantize_for).
// What the design does about it (second design; the first read each row
//   twice, the dense entry with 2-byte loads, and was written twice):
//   - One template for both entries: the dense entry is the routed one with
//     no counts (E = 1).
//   - Single pass: each thread loads its share of the row once, with 16-byte
//     loads, into registers (up to kChunks = 4 chunks), reduces |x| to the
//     row's amax (warp shuffles, then one shuffle over the row's warps'
//     maxima in shared memory) and writes the codes from the registers.
//     Every load of a thread is issued before the first is used: a load
//     inside its own branch, reduced before the next was issued, costs one
//     device-memory round trip per chunk (on the H100 that made a row about
//     1 us slower than the first design's two passes). At 1024
//     threads a row holds 32768 bf16 or 16384 f32 values; a longer row
//     loops over slabs of 4 * 1024 chunks, every slab but the last read
//     again for its codes (from L2), in the same kernel.
//   - Block shape by K: tpr threads quantize a row, the most (a power of two
//     from 32 to 1024) that still gives each thread two chunks. At decode
//     only 4 rows run, one block each, so a row's latency is the cost: its
//     loads, then each thread's divides one after another (the IEEE
//     division's slow-path branch keeps the compiler from overlapping
//     them), which more threads a row cut; but on the H100 one chunk a
//     thread at 1024 threads was slower than two at 512 (4 x 11008 bf16).
//     The served rows take 256 threads (K = 4096 bf16, 2 chunks each) or
//     512 (11008 and 14336, 2 to 4); rows shorter than 512 chunks share a
//     block of 256 threads (256 / tpr rows) instead of leaving warps idle.
//   - Any K and any base: where K is no multiple of the chunk's elements or
//     a pointer is not aligned, an instance loads and stores element by
//     element (VEC = false) with the same arithmetic.
// Bit-exactness with the plain PyTorch version: f32 amax; a true division
//   fmaxf(amax, 1e-8f) / qm; rintf (round half to even, like torch.round and
//   jnp.round) of a true division x / scale; a clamp to +-qm. The library is
//   built without --use_fast_math, which would make '/' approximate. A NaN in
//   the row propagates into the row's scale, as torch.amax does, and a code
//   whose quotient is NaN (a NaN or inf row) is 0, as torch's float -> int8
//   conversion on the card gives it.
// The routed entry (x (E*C, K), row m of expert e routed when
//   m < min(counts[e], C)): an unrouted row reads nothing and gets zero codes
//   and scale 0, so the grouped GEMM sees defined codes whatever the buffer
//   holds past the counts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"  // routed_rows

namespace {

constexpr int kMaxThreads = 1024;  // threads a row can take (one block)
constexpr int kMinBlock = 256;     // threads of a block that holds short rows
constexpr int kChunks = 4;         // 16-byte chunks a thread holds

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// max that propagates NaN (fmaxf drops it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The code of v at scale s: rint(v / s) clamped to +-qm, 0 where the
// quotient is NaN
__device__ __forceinline__ int8_t code(float v, float s, float qm) {
  const float r = rintf(v / s);
  if (r != r) return 0;
  return static_cast<int8_t>(__float2int_rn(fminf(fmaxf(r, -qm), qm)));
}

// Rows [blockIdx.x * (blockDim.x >> sh), ...) of x (rows, K), tpr = 1 << sh
// threads a row (a power of two: every index below is a shift). With
// counts, row r belongs to expert r / C and is routed when
// r % C < min(counts[e], C); without, every row is.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
act_quant_kernel(const T* __restrict__ x, const int* __restrict__ counts,
                 int8_t* __restrict__ q, float* __restrict__ scale, int rows,
                 int C, int K, int sh, float qm) {
  constexpr int V = 16 / sizeof(T);  // elements of one chunk
  using Codes = typename std::conditional<V == 8, uint2, uint32_t>::type;
  const int tpr = 1 << sh;
  const int lt = threadIdx.x & (tpr - 1);  // this thread's place in its row
  const int row = static_cast<int>(
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> sh);
  const bool in = row < rows;
  bool live = in;
  if (in && counts != nullptr) {
    const int e = row / C;
    live = row - e * C < routed_rows(counts, e, C);
  }
  const T* xr = x + static_cast<int64_t>(row) * K;
  int8_t* qr = q + static_cast<int64_t>(row) * K;
  const int nch = (K + V - 1) / V;          // chunks of the row
  const int slab = kChunks << sh;           // chunks the row's threads hold
  const int passes = (nch + slab - 1) / slab;

  // an unrouted row: zero codes and scale, no load, no divide
  auto zeros = [&]() {
    for (int c = lt; c < nch; c += tpr) {
      if constexpr (VEC) {
        reinterpret_cast<Codes*>(qr)[c] = Codes{};
      } else {
        for (int i = 0; i < V && c * V + i < K; ++i) qr[c * V + i] = 0;
      }
    }
    if (lt == 0) scale[row] = 0.f;
  };
  if (in && !live && static_cast<int>(blockDim.x) == tpr) {
    zeros();  // the block is this one row: nothing else waits on it
    return;
  }

  union Chunk {
    int4 raw;
    T e[V];
  };
  Chunk v[kChunks] = {};
  // registers <- slab p of the row: every load issued before any is used
  auto load = [&](int p) {
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = p * slab + j * tpr + lt;
      if constexpr (VEC) {
        if (live && c < nch) {
          v[j].raw = __ldg(reinterpret_cast<const int4*>(xr) + c);
        }
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (live && c * V + i < K) v[j].e[i] = xr[c * V + i];
        }
      }
    }
  };
  float amax = 0.f;
  for (int p = 0; p < passes; ++p) {
    load(p);
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = p * slab + j * tpr + lt;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (live && c * V + i < K) {
          amax = nan_max(amax, fabsf(to_f32(v[j].e[i])));
        }
      }
    }
  }

  // the row's amax: each warp's by shuffles, then the row's warps' maxima
  // (0 is neutral: |x| >= 0, and NaN wins)
  __shared__ float warp_max[kMaxThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  float m = lane < (tpr >> 5)
                ? warp_max[((threadIdx.x >> sh) << (sh - 5)) + lane]
                : 0.f;
  for (int off = 16; off > 0; off >>= 1) {
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  const float s = (m != m ? m : fmaxf(m, 1e-8f)) / qm;
  if (!in) return;
  if (!live) {  // an unrouted row sharing its block with others
    zeros();
    return;
  }
  if (lt == 0) scale[row] = s;

  // codes, last slab first: it is still in the registers
  for (int p = passes - 1; p >= 0; --p) {
    if (p != passes - 1) load(p);
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = p * slab + j * tpr + lt;
      if (c >= nch) continue;
      if constexpr (VEC) {
        union {
          int8_t c[V];
          Codes w;
        } u;
#pragma unroll
        for (int i = 0; i < V; ++i) u.c[i] = code(to_f32(v[j].e[i]), s, qm);
        reinterpret_cast<Codes*>(qr)[c] = u.w;
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (c * V + i < K) qr[c * V + i] = code(to_f32(v[j].e[i]), s, qm);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const int* counts, void* q, void* scale,
                   int rows, int C, int K, int qm, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int nch = (K + V - 1) / V;
  int sh = 5;  // tpr = 1 << sh: two chunks a thread where the row has them
  while ((1 << sh) < kMaxThreads && (4 << sh) <= nch) ++sh;
  const int block = (1 << sh) > kMinBlock ? 1 << sh : kMinBlock;
  const int per = block >> sh;  // rows a block
  const unsigned grid = static_cast<unsigned>((rows + per - 1) / per);
  const bool vec = K % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const auto* xt = static_cast<const T*>(x);
  auto* qo = static_cast<int8_t*>(q);
  auto* so = static_cast<float*>(scale);
  const float qf = static_cast<float>(qm);
  if (vec) {
    act_quant_kernel<T, true><<<grid, block, 0, st>>>(
        xt, counts, qo, so, rows, C, K, sh, qf);
  } else {
    act_quant_kernel<T, false><<<grid, block, 0, st>>>(
        xt, counts, qo, so, rows, C, K, sh, qf);
  }
  return cudaGetLastError();
}

int launch_rows(const void* x, int x_is_bf16, const void* counts, void* q,
                void* scale, int rows, int C, int K, int qm, void* stream) {
  if (rows > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto* cn = static_cast<const int*>(counts);
    return static_cast<int>(
        x_is_bf16 ? launch<__nv_bfloat16>(x, cn, q, scale, rows, C, K, qm, st)
                  : launch<float>(x, cn, q, scale, rows, C, K, qm, st));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (M, K) bf16 (x_is_bf16 = 1) or f32, contiguous, any K. q: (M, K) int8.
// scale: (M,) f32. Returns cudaGetLastError() after the launch.
extern "C" int act_quant_launch(const void* x, int x_is_bf16, void* q,
                                void* scale, int M, int K, int qm,
                                void* stream) {
  if (M < 0 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_rows(x, x_is_bf16, nullptr, q, scale, M, M, K, qm, stream);
}

// The routed rows of a grouped launch. x: (E*C, K) bf16 (x_is_bf16 = 1) or
// f32, contiguous, any K; counts (E,) int32 or null (every row routed).
// q: (E*C, K) int8; sa: (E*C,) f32, 0 past the counts. Returns
// cudaGetLastError() after the launch.
extern "C" int act_quant_routed_launch(const void* x, int x_is_bf16,
                                       const void* counts, void* q, void* sa,
                                       int E, int C, int K, int qm,
                                       void* stream) {
  if (E < 0 || C < 0 || K < 0 || static_cast<int64_t>(E) * C > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_rows(x, x_is_bf16, counts, q, sa, E * C, C, K, qm, stream);
}
