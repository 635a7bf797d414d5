// The W4A16 tile loop of the ragged batched-expert GEMM (moe_w4a16.cu),
// its one remaining user. The dense W4A16 GEMM (w4a16_gemm.cu) ran on it
// until its second design (split K, a cp.async ring of packed bytes and
// dequantization straight into the MMA fragments), which no longer uses it.
//
// Per 128-row packing unit, the bf16 activations are copied to shared
// memory with 16-byte loads, and the packed int4 weights are unpacked (the
// layout and sign extension of w4a8_tile.cuh) and dequantized as
// __float2bfloat16_rn(float(w) * s[g, n]) into shared memory, bf16 and
// k-contiguous per output column. That is round-to-nearest-even, as the
// plain version's .to(bfloat16) is, so the dequantized weights are
// bit-identical to it. bf16 tensor-core MMAs (mma.sync m16n8k16, f32
// accumulate) then run over the whole K with no per-group epilogue: the
// scale is baked into the dequantized weight. The tile is BM x 64 outputs,
// BM = 16 for decode and 64 for prefill, as in the W4A8 kernels.
//
// Experts as in w4a8_tile.cuh: blockIdx.z is the expert e, its rows are
// [e*C, e*C + C), its weights and scales the e-th slabs, with 64-bit bases;
// only rows below min(counts[e], C) are routed, an m-tile wholly past that
// writes zeros and returns, and unrouted rows of an active tile are written
// as exact zeros. The dense-grouped entry point is the case of no counts.
#pragma once

#include <cuda_bf16.h>

#include "w4a8_tile.cuh"

namespace {

constexpr int KPAD16 = KC + 8;  // shared row stride in bf16 (bank spread)

struct WoArgs {
  const __nv_bfloat16* x;  // (E*C, K)
  const int8_t* w;         // (E, K/2, N) packed int4
  const float* s;          // (E, K/gs, N)
  float* out;              // (E*C, N)
  const int* counts;       // (E,) routed rows per expert; nullptr = C each
  int C, N, K, gs;
};

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

// The pointers are separate __restrict__ parameters (rebuilt into the
// struct inside), as in the earlier dense kernel: measured on the H100,
// this loop taking the struct whole ran 20 % slower at BM = 64, with or
// without __ldg (the W4A8 loop is the other way round: see TileArgs).
template <int BM>
__global__ void __launch_bounds__(kThreads)
w4a16_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wq,
             const float* __restrict__ sc, float* __restrict__ out,
             const int* __restrict__ counts, int C_, int N_, int K_,
             int gs_) {
  const WoArgs a{x, wq, sc, out, counts, C_, N_, K_, gs_};
  constexpr int WARPS_M = BM / 16;      // 1 (decode) or 4 (prefill)
  constexpr int WARPS_N = 4 / WARPS_M;  // 4 or 1
  constexpr int WN = BN / WARPS_N;      // columns per warp: 16 or 64
  constexpr int NF = WN / 8;            // m16n8 fragments per warp: 2 or 8

  __shared__ __align__(16) __nv_bfloat16 As[BM][KPAD16];
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][KPAD16];

  const int N = a.N, K = a.K, gs = a.gs, C = a.C;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int64_t row0 = static_cast<int64_t>(e) * C;  // the expert's row 0
  const int rc = routed_rows(a.counts, e, C);
  if (m0 >= rc) {  // no routed row in this m-tile
    write_zero_tile<BM>(a.out, row0, m0, n0, C, N);
    return;
  }
  const int nrows = rc - m0 < BM ? rc - m0 : BM;  // routed rows of the tile
  const int64_t trow0 = row0 + m0;                // the tile's first row
  const int8_t* w = a.w + static_cast<int64_t>(e) * (K / 2) * N;
  const float* s = a.s + static_cast<int64_t>(e) * (K / gs) * N;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, t = lane & 3;  // mma groupID / thread-in-group

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
      if (r < nrows) {
        v = __ldg(
            reinterpret_cast<const int4*>(a.x + (trow0 + r) * K + k0 + c));
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
        const float slo = __ldg(s + (int64_t)((k0 + b) / gs) * N + n0 + n);
        const float shi =
            __ldg(s + (int64_t)((k0 + KC / 2 + b) / gs) * N + n0 + n);
        int v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = __ldg(p + (int64_t)j * N);
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
      uint32_t af[4];
      af[0] = *reinterpret_cast<const uint32_t*>(&As[ar][ks + t * 2]);
      af[1] = *reinterpret_cast<const uint32_t*>(&As[ar + 8][ks + t * 2]);
      af[2] = *reinterpret_cast<const uint32_t*>(&As[ar][ks + 8 + t * 2]);
      af[3] = *reinterpret_cast<const uint32_t*>(&As[ar + 8][ks + 8 + t * 2]);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int bn = wn * WN + f * 8 + g;
        uint32_t bf[2];
        bf[0] = *reinterpret_cast<const uint32_t*>(&Bs[bn][ks + t * 2]);
        bf[1] = *reinterpret_cast<const uint32_t*>(&Bs[bn][ks + 8 + t * 2]);
        mma_bf16(acc[f], af, bf);
      }
    }
    __syncthreads();
  }

  // unrouted rows of the tile are written as exact zeros
  const int lr0 = wm * 16 + g, lr1 = lr0 + 8;  // rows within the tile
  float* o0 = a.out + (trow0 + lr0) * N;
  float* o1 = a.out + (trow0 + lr1) * N;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int n = n0 + wn * WN + f * 8 + t * 2;
    if (m0 + lr0 < C) {
      if (n < N) o0[n] = lr0 < nrows ? acc[f][0] : 0.f;
      if (n + 1 < N) o0[n + 1] = lr0 < nrows ? acc[f][1] : 0.f;
    }
    if (m0 + lr1 < C) {
      if (n < N) o1[n] = lr1 < nrows ? acc[f][2] : 0.f;
      if (n + 1 < N) o1[n + 1] = lr1 < nrows ? acc[f][3] : 0.f;
    }
  }
}

// Checks what the kernel cannot take, picks the row tile, launches, and
// returns cudaGetLastError().
inline int w4a16_launch(const WoArgs& a, int E, int bm, void* stream) {
  if (a.K % KC != 0 || a.gs <= 0 || a.gs % 16 != 0 || a.K % a.gs != 0 ||
      E <= 0 || E > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.C > 0 && a.N > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (bm == 16) {
      const dim3 grid((a.N + BN - 1) / BN, (a.C + 15) / 16, E);
      w4a16_kernel<16><<<grid, kThreads, 0, st>>>(a.x, a.w, a.s, a.out,
                                                  a.counts, a.C, a.N, a.K,
                                                  a.gs);
    } else if (bm == 64) {
      const dim3 grid((a.N + BN - 1) / BN, (a.C + 63) / 64, E);
      w4a16_kernel<64><<<grid, kThreads, 0, st>>>(a.x, a.w, a.s, a.out,
                                                  a.counts, a.C, a.N, a.K,
                                                  a.gs);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
