// Fine-grained W4A16 weight-only GEMM: the Marlin analog the paper compares
// against.
//
//   O = X_bf16 @ bf16(W_int4 * s_g)     (f32 accumulation over all of K)
//
// Replaces: src/repro/kernels/w4a16_gemm.py::w4a16_gemm, the Pallas TPU
//   kernel (_kernel, _dequant_group_accumulate, _unpack_wblock).
// What bounds it on the H100: at decode (M <= 4) device-memory bytes: the
//   packed int4 weights (K*N/2 bytes) and f32 group scales are read once for
//   a handful of rows, a quarter of a bf16 weight's bytes. That is Marlin's
//   case and the reason weight-only quantization exists. At prefill
//   (M = 128) bf16 tensor-core operations and bytes are of the same order.
// What the design does about it: per 128-row packing unit, the bf16
//   activations are copied to shared memory with 16-byte loads, and the
//   packed int4 weights are unpacked (the layout and sign extension of
//   w4a8_tile.cuh) and dequantized as __float2bfloat16_rn(float(w) *
//   s[g, n]) into shared memory, bf16 and k-contiguous per output column.
//   That is round-to-nearest-even, as the plain version's .to(bfloat16) is,
//   so the dequantized weights are bit-identical to it. bf16 tensor-core
//   MMAs (mma.sync m16n8k16, f32 accumulate) then run over the whole K with
//   no per-group epilogue: the scale is baked into the dequantized weight.
//   The tile is BM x 64 outputs, BM = 16 for decode and 64 for prefill, as
//   in the W4A8 kernels. No wgmma or TMA yet: a simple kernel that is right
//   comes first.
// bf16 x bf16 products are exact in f32, so only the order of the f32 sum
//   differs from the plain version.
#include <cuda_bf16.h>

#include "w4a8_tile.cuh"

namespace {

constexpr int KPAD16 = KC + 8;  // shared row stride in bf16 (bank spread)

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two dequantized codes as a bf16 pair (the first in the low half)
__device__ __forceinline__ uint32_t dequant2(int c0, int c1, float s) {
  const uint32_t lo = __bfloat16_as_ushort(
      __float2bfloat16_rn(__fmul_rn(static_cast<float>(c0), s)));
  const uint32_t hi = __bfloat16_as_ushort(
      __float2bfloat16_rn(__fmul_rn(static_cast<float>(c1), s)));
  return lo | (hi << 16);
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
w4a16_kernel(const __nv_bfloat16* __restrict__ x,  // (M, K)
             const int8_t* __restrict__ w,         // (K/2, N) packed int4
             const float* __restrict__ s,          // (K/gs, N)
             float* __restrict__ out,              // (M, N)
             int M, int N, int K, int gs) {
  constexpr int WARPS_M = BM / 16;      // 1 (decode) or 4 (prefill)
  constexpr int WARPS_N = 4 / WARPS_M;  // 4 or 1
  constexpr int WN = BN / WARPS_N;      // columns per warp: 16 or 64
  constexpr int NF = WN / 8;            // m16n8 fragments per warp: 2 or 8

  __shared__ __align__(16) __nv_bfloat16 As[BM][KPAD16];
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][KPAD16];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, t = lane & 3;  // mma groupID / thread-in-group
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[NF][4];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[f][i] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += KC) {
    // activations: BM rows x 128 bf16, 8 values (16 bytes) a thread
    for (int i = tid; i < BM * (KC / 8); i += kThreads) {
      const int r = i / (KC / 8), c = (i % (KC / 8)) * 8;
      int4 v = make_int4(0, 0, 0, 0);
      if (m0 + r < M) {
        v = *reinterpret_cast<const int4*>(x + (int64_t)(m0 + r) * K + k0 + c);
      }
      *reinterpret_cast<int4*>(&As[r][c]) = v;
    }
    // weights -> Bs[n][k], dequantized bf16, k-contiguous per column:
    // packed rows b..b+3 of column n hold k = b..b+3 (low nibbles) and
    // k = 64+b..64+b+3 (high nibbles); gs % 16 == 0 keeps each run of four
    // in one group
    for (int i = tid; i < (KC / 8) * BN; i += kThreads) {
      const int n = i % BN, b = (i / BN) * 4;
      uint2 lo = make_uint2(0u, 0u), hi = make_uint2(0u, 0u);
      if (n0 + n < N) {
        const int8_t* p = w + (int64_t)(k0 / 2 + b) * N + n0 + n;
        const float slo = s[(int64_t)((k0 + b) / gs) * N + n0 + n];
        const float shi = s[(int64_t)((k0 + KC / 2 + b) / gs) * N + n0 + n];
        int v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = p[(int64_t)j * N];
        lo.x = dequant2(lo_nibble(v[0]), lo_nibble(v[1]), slo);
        lo.y = dequant2(lo_nibble(v[2]), lo_nibble(v[3]), slo);
        hi.x = dequant2(hi_nibble(v[0]), hi_nibble(v[1]), shi);
        hi.y = dequant2(hi_nibble(v[2]), hi_nibble(v[3]), shi);
      }
      *reinterpret_cast<uint2*>(&Bs[n][b]) = lo;
      *reinterpret_cast<uint2*>(&Bs[n][KC / 2 + b]) = hi;
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < KC; ks += 16) {
      const int ar = wm * 16 + g;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(&As[ar][ks + t * 2]);
      a[1] = *reinterpret_cast<const uint32_t*>(&As[ar + 8][ks + t * 2]);
      a[2] = *reinterpret_cast<const uint32_t*>(&As[ar][ks + 8 + t * 2]);
      a[3] = *reinterpret_cast<const uint32_t*>(&As[ar + 8][ks + 8 + t * 2]);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int bn = wn * WN + f * 8 + g;
        uint32_t bf[2];
        bf[0] = *reinterpret_cast<const uint32_t*>(&Bs[bn][ks + t * 2]);
        bf[1] = *reinterpret_cast<const uint32_t*>(&Bs[bn][ks + 8 + t * 2]);
        mma_bf16(acc[f], a, bf);
      }
    }
    __syncthreads();
  }

  const int r0 = m0 + wm * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int n = n0 + wn * WN + f * 8 + t * 2;
    if (r0 < M) {
      if (n < N) out[(int64_t)r0 * N + n] = acc[f][0];
      if (n + 1 < N) out[(int64_t)r0 * N + n + 1] = acc[f][1];
    }
    if (r1 < M) {
      if (n < N) out[(int64_t)r1 * N + n] = acc[f][2];
      if (n + 1 < N) out[(int64_t)r1 * N + n + 1] = acc[f][3];
    }
  }
}

template <int BM>
void launch(const void* x, const void* w, const void* s, void* out, int M,
            int N, int K, int gs, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  w4a16_kernel<BM><<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(s), static_cast<float*>(out), M, N, K, gs);
}

}  // namespace

// x (M, K) bf16, 16-byte aligned; w (K/2, N) packed int4; s (K/gs, N) f32;
// out (M, N) f32. All contiguous. K % 128 == 0, K % gs == 0, gs % 16 == 0.
// bm is 16 or 64. Returns cudaGetLastError() after the launch.
extern "C" int w4a16_gemm_launch(const void* x, const void* w, const void* s,
                                 void* out, int M, int N, int K, int gs,
                                 int bm, void* stream) {
  if (K % KC != 0 || gs <= 0 || gs % 16 != 0 || K % gs != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M > 0 && N > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (bm == 16) {
      launch<16>(x, w, s, out, M, N, K, gs, st);
    } else if (bm == 64) {
      launch<64>(x, w, s, out, M, N, K, gs, st);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
