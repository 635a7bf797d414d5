// The tile loop shared by the W4A8 / W8A8 GEMMs: Integer Scale (paper
// Eq. 2, w4a8_gemm_is.cu) and float scale (Eq. 1, w4a8_gemm_fs.cu).
//
// The two kernels differ only in what happens when a quantization group
// ends (the Scale policy's group()) and in the epilogue (out()); both
// include this one loop, so a time difference between them measures only
// the per-group step. The loop: each stage stages one 128-row packing unit;
// the int8 activations are copied to shared memory with 16-byte loads and
// the packed int4 weights are unpacked there (two shift pairs per byte,
// sign-extended, k-contiguous per output column), so both operands of the
// int8 tensor-core MMA (mma.sync m16n8k32 s8 -> s32) are read with
// conflict-free 32-bit shared loads. Each group's int32 partial is handed
// to the policy at the group's end. The tile is BM x 64 outputs with
// BM = 16 for decode and BM = 64 for prefill.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;         // output columns per block
constexpr int KC = 128;        // k per stage: one packing layout unit
constexpr int KPAD = KC + 16;  // shared row stride in bytes (bank spread)
constexpr int kThreads = 128;  // 4 warps

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// sign-extended low / high nibble of a sign-extended packed byte
__device__ __forceinline__ int lo_nibble(int v) {
  return static_cast<int>(static_cast<unsigned>(v) << 28) >> 28;
}
__device__ __forceinline__ int hi_nibble(int v) {
  return static_cast<int>(static_cast<unsigned>(v) << 24) >> 28;
}

// Scale is the policy: Scale::Acc / Scale::Value are the accumulator and
// group-scale types, Scale::group(acc, part, s) folds one group's int32
// partial into the accumulator, Scale::out(acc, fac) is the epilogue.
template <int BM, bool W4, class Scale>
__global__ void __launch_bounds__(kThreads)
w4a8_kernel(const int8_t* __restrict__ xq,                   // (M, K)
            const float* __restrict__ fac,                   // (M,)
            const int8_t* __restrict__ w,                    // W4: (K/2, N); W8: (K, N)
            const typename Scale::Value* __restrict__ s,     // (K/gs, N)
            float* __restrict__ out,                         // (M, N)
            int M, int N, int K, int gs) {
  using Acc = typename Scale::Acc;
  using Value = typename Scale::Value;
  constexpr int WARPS_M = BM / 16;      // 1 (decode) or 4 (prefill)
  constexpr int WARPS_N = 4 / WARPS_M;  // 4 or 1
  constexpr int WN = BN / WARPS_N;      // columns per warp: 16 or 64
  constexpr int NF = WN / 8;            // m16n8 fragments per warp: 2 or 8

  __shared__ __align__(16) int8_t As[BM][KPAD];
  __shared__ __align__(16) int8_t Bs[BN][KPAD];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, t = lane & 3;  // mma groupID / thread-in-group
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  Acc acc[NF][4];
  int part[NF][4];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[f][i] = Acc(0);
      part[f][i] = 0;
    }
  }

  for (int k0 = 0; k0 < K; k0 += KC) {
    // activations: BM rows x 128 bytes, 16 bytes a thread
    for (int i = tid; i < BM * (KC / 16); i += kThreads) {
      const int r = i / (KC / 16), c = (i % (KC / 16)) * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (m0 + r < M) {
        v = *reinterpret_cast<const int4*>(xq + (int64_t)(m0 + r) * K + k0 + c);
      }
      *reinterpret_cast<int4*>(&As[r][c]) = v;
    }
    // weights -> Bs[n][k], k-contiguous int8 per output column
    if (W4) {
      // packed rows b..b+3 of column n: low nibbles are k = b..b+3, high
      // nibbles k = 64+b..64+b+3 (repro_torch.core.packing layout)
      for (int i = tid; i < (KC / 8) * BN; i += kThreads) {
        const int n = i % BN, b = (i / BN) * 4;
        uint32_t lo = 0, hi = 0;
        if (n0 + n < N) {
          const int8_t* p = w + (int64_t)(k0 / 2 + b) * N + n0 + n;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int v = p[(int64_t)j * N];
            lo |= (static_cast<uint32_t>(lo_nibble(v)) & 0xFFu) << (8 * j);
            hi |= (static_cast<uint32_t>(hi_nibble(v)) & 0xFFu) << (8 * j);
          }
        }
        *reinterpret_cast<uint32_t*>(&Bs[n][b]) = lo;
        *reinterpret_cast<uint32_t*>(&Bs[n][KC / 2 + b]) = hi;
      }
    } else {
      for (int i = tid; i < (KC / 4) * BN; i += kThreads) {
        const int n = i % BN, kk = (i / BN) * 4;
        uint32_t v4 = 0;
        if (n0 + n < N) {
          const int8_t* p = w + (int64_t)(k0 + kk) * N + n0 + n;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v4 |= static_cast<uint32_t>(static_cast<uint8_t>(p[(int64_t)j * N]))
                  << (8 * j);
          }
        }
        *reinterpret_cast<uint32_t*>(&Bs[n][kk]) = v4;
      }
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < KC; ks += 32) {
      const int ar = wm * 16 + g;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(&As[ar][ks + t * 4]);
      a[1] = *reinterpret_cast<const uint32_t*>(&As[ar + 8][ks + t * 4]);
      a[2] = *reinterpret_cast<const uint32_t*>(&As[ar][ks + 16 + t * 4]);
      a[3] = *reinterpret_cast<const uint32_t*>(&As[ar + 8][ks + 16 + t * 4]);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int bn = wn * WN + f * 8 + g;
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(&Bs[bn][ks + t * 4]);
        b[1] = *reinterpret_cast<const uint32_t*>(&Bs[bn][ks + 16 + t * 4]);
        mma_s8(part[f], a, b);
      }
      const int kend = k0 + ks + 32;
      if (kend % gs == 0) {
        // a quantization group ends: the policy's group step
        const int grp = kend / gs - 1;
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const int n = n0 + wn * WN + f * 8 + t * 2;
          const Value s0 = n < N ? s[(int64_t)grp * N + n] : Value(0);
          const Value s1 = n + 1 < N ? s[(int64_t)grp * N + n + 1] : Value(0);
          acc[f][0] = Scale::group(acc[f][0], part[f][0], s0);
          acc[f][1] = Scale::group(acc[f][1], part[f][1], s1);
          acc[f][2] = Scale::group(acc[f][2], part[f][2], s0);
          acc[f][3] = Scale::group(acc[f][3], part[f][3], s1);
#pragma unroll
          for (int i = 0; i < 4; ++i) part[f][i] = 0;
        }
      }
    }
    __syncthreads();
  }

  // epilogue: the policy's output step with the per-row factor
  const int r0 = m0 + wm * 16 + g, r1 = r0 + 8;
  const float f0 = r0 < M ? fac[r0] : 0.f;
  const float f1 = r1 < M ? fac[r1] : 0.f;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int n = n0 + wn * WN + f * 8 + t * 2;
    if (r0 < M) {
      if (n < N) out[(int64_t)r0 * N + n] = Scale::out(acc[f][0], f0);
      if (n + 1 < N) out[(int64_t)r0 * N + n + 1] = Scale::out(acc[f][1], f0);
    }
    if (r1 < M) {
      if (n < N) out[(int64_t)r1 * N + n] = Scale::out(acc[f][2], f1);
      if (n + 1 < N) out[(int64_t)r1 * N + n + 1] = Scale::out(acc[f][3], f1);
    }
  }
}

template <class Scale, int BM>
void w4a8_launch_bm(const void* xq, const void* fac, const void* w,
                    const void* s, void* out, int M, int N, int K, int gs,
                    int w_bits, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const auto* x8 = static_cast<const int8_t*>(xq);
  const auto* f32 = static_cast<const float*>(fac);
  const auto* w8 = static_cast<const int8_t*>(w);
  const auto* sv = static_cast<const typename Scale::Value*>(s);
  auto* o = static_cast<float*>(out);
  if (w_bits == 4) {
    w4a8_kernel<BM, true, Scale><<<grid, kThreads, 0, st>>>(x8, f32, w8, sv, o, M, N, K, gs);
  } else {
    w4a8_kernel<BM, false, Scale><<<grid, kThreads, 0, st>>>(x8, f32, w8, sv, o, M, N, K, gs);
  }
}

// The body of each kernel's C entry point: checks what the kernel cannot
// take, picks the row tile, launches, returns cudaGetLastError().
template <class Scale>
int w4a8_launch(const void* xq, const void* fac, const void* w, const void* s,
                void* out, int M, int N, int K, int gs, int w_bits, int bm,
                void* stream) {
  if ((w_bits != 4 && w_bits != 8) || K % KC != 0 || gs <= 0 || gs % 32 != 0 ||
      K % gs != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M > 0 && N > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (bm == 16) {
      w4a8_launch_bm<Scale, 16>(xq, fac, w, s, out, M, N, K, gs, w_bits, st);
    } else if (bm == 64) {
      w4a8_launch_bm<Scale, 64>(xq, fac, w, s, out, M, N, K, gs, w_bits, st);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
