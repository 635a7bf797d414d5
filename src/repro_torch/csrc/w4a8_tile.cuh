// The tile loop shared by the W4A8 / W8A8 GEMMs: Integer Scale (paper
// Eq. 2; w4a8_gemm_is.cu, and grouped over experts moe_w4a8_is.cu) and
// float scale (Eq. 1; w4a8_gemm_fs.cu and moe_w4a8_fs.cu).
//
// The kernels differ only in what happens when a quantization group ends
// (the Scale policy's group(): IntegerScale or FloatScale below) and in the
// epilogue (out()); all include this one loop, so a time difference between
// IS and FS measures only the per-group step. The loop: each stage stages
// one 128-row packing unit; the int8 activations are put in shared memory
// by the activation-source policy (Act, below) and the packed int4 weights
// are unpacked there (two shift pairs per byte, sign-extended, k-contiguous
// per output column), so both operands of the int8 tensor-core MMA
// (mma.sync m16n8k32 s8 -> s32) are read with conflict-free 32-bit shared
// loads. Each group's int32 partial is handed to the policy at the group's
// end. The tile is BM x 64 outputs with BM = 16 for decode and BM = 64 for
// prefill.
//
// Experts: blockIdx.z is the expert e. Its rows are rows [e*C, e*C + C) of
// the (E*C, K) activations and output, its weights and scales the e-th
// slab of (E, K/2 | K, N) and (E, K/gs, N); every base offset is 64-bit (the
// W8 weights of one grouped linear exceed 2^31 bytes' reach of an int). Only
// rows below rc = min(counts[e], C) are routed: a block whose m-tile starts
// at or past rc writes zeros and returns (the TPU kernel's skipped m-tiles),
// and inside an active tile rows at or past rc are staged as zero codes and
// written as exact zeros. Rows at or past C belong to the next expert and
// are never touched. The dense GEMMs are the case E = 1, C = M, no counts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;         // output columns per block
constexpr int KC = 128;        // k per stage: one packing layout unit
constexpr int KPAD = KC + 16;  // shared row stride in bytes (bank spread)
constexpr int kThreads = 128;  // 4 warps

// What a launch reads and writes (all device pointers). The W4A8 kernel
// takes it whole and reads every input with __ldg (the read-only data
// path), since a struct's pointers carry no __restrict__. Measured on the
// H100 (chip_smoke.py) against the separate __restrict__ parameters of the
// earlier dense kernels: about 20 % faster at BM = 64 and level at BM = 16,
// where this loop taking __restrict__ parameters was 26-30 % slower.
struct TileArgs {
  const void* x;       // activations: int8 codes or raw bf16/f32, (E*C, K)
  const float* fac;    // codes only: per-row factor (E*C,)
  const int8_t* w;     // (E, K/2, N) packed int4 or (E, K, N) int8
  const void* s;       // (E, K/gs, N) group scales, int32 (IS) or f32 (FS)
  float* out;          // (E*C, N)
  const int* counts;   // (E,) routed rows per expert; nullptr = C each
  const float* alpha;  // (E,) divisor of the row factor; nullptr = none
  int C, N, K, gs;
  float qm;            // raw activations: the largest code (2^(bits-1) - 1)
};

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

// Routed rows of expert e: min(counts[e], C), clamped at 0.
__device__ __forceinline__ int routed_rows(const int* counts, int e, int C) {
  if (counts == nullptr) return C;
  const int c = counts[e];
  return c < 0 ? 0 : (c < C ? c : C);
}

// Zeros for rows [m0, min(m0 + BM, C)) x columns [n0, n0 + BN) of this
// expert: the output of a skipped m-tile.
template <int BM>
__device__ __forceinline__ void write_zero_tile(float* out, int64_t row0,
                                                int m0, int n0, int C,
                                                int N) {
  for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
    const int r = m0 + i / BN, n = n0 + i % BN;
    if (r < C && n < N) out[(row0 + r) * N + n] = 0.f;
  }
}

// ---------------------------------------------------------------------------
// Scale policies: Scale::Acc / Scale::Value are the accumulator and
// group-scale types, Scale::group(acc, part, s) folds one group's int32
// partial into the accumulator, Scale::out(acc, fac) is the epilogue.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int wrap_mad(int acc, int a, int b) {
  return static_cast<int>(static_cast<unsigned>(acc) +
                          static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// Eq. 2: the group step in int32 (two's complement wrap like the
// reference's int32; the quantizer caps alpha so it never wraps), one
// I32 -> F32 convert in the epilogue.
struct IntegerScale {
  using Acc = int;
  using Value = int;
  __device__ static __forceinline__ int group(int acc, int part, int s) {
    return wrap_mad(acc, part, s);
  }
  __device__ static __forceinline__ float out(int acc, float fac) {
    return __int2float_rn(acc) * fac;
  }
};

// Eq. 1: the group step is an I32 -> F32 convert, multiply, add (explicit
// _rn intrinsics, no fused multiply-add, so each step rounds as the plain
// version's product-then-sum does).
struct FloatScale {
  using Acc = float;
  using Value = float;
  __device__ static __forceinline__ float group(float acc, int part, float s) {
    return __fadd_rn(acc, __fmul_rn(__int2float_rn(part), s));
  }
  __device__ static __forceinline__ float out(float acc, float fac) {
    return __fmul_rn(acc, fac);
  }
};

// ---------------------------------------------------------------------------
// Activation-source policies. Act::begin(a, row0, nrows, rs) runs once per
// block (rs: BM floats of shared memory); Act::stage(...) fills As with the
// int8 codes of the chunk [k0, k0 + 128) of rows [0, nrows) of the tile and
// zeros below; Act::factor(a, row, rs, r) is the row's epilogue factor
// before the per-expert alpha.
// ---------------------------------------------------------------------------

// int8 codes and a per-row factor from memory (the dense GEMMs, and the
// grouped entry points that take pre-quantized activations).
struct ActCodes {
  template <int BM>
  __device__ static __forceinline__ void begin(const TileArgs&, int64_t, int,
                                               float*) {}

  template <int BM>
  __device__ static __forceinline__ void stage(const TileArgs& a,
                                               int64_t row0, int nrows,
                                               int k0, int8_t (*As)[KPAD],
                                               const float*) {
    // the tile's rows; r * K fits an int (BM * K < 2^31)
    const int8_t* xq = static_cast<const int8_t*>(a.x) + row0 * a.K;
    // BM rows x 128 bytes, 16 bytes a thread
    for (int i = threadIdx.x; i < BM * (KC / 16); i += kThreads) {
      const int r = i / (KC / 16), c = (i % (KC / 16)) * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (r < nrows) {
        v = __ldg(reinterpret_cast<const int4*>(xq + r * a.K + k0 + c));
      }
      *reinterpret_cast<int4*>(&As[r][c]) = v;
    }
  }

  __device__ static __forceinline__ float factor(const TileArgs& a,
                                                 int64_t row, const float*,
                                                 int) {
    return __ldg(a.fac + row);
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// max that propagates NaN (fmaxf drops it), as act_quant.cu and torch.amax
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Raw bf16/f32 rows, quantized per token inside the block with
// act_quant.cu's arithmetic (so the codes are bit-identical to the
// act_quant kernel's and to act_quant_plain's): one pass over the tile's
// rows takes each row's amax and its scale max(amax, 1e-8) / qm, a true
// division; then each 128-wide chunk is quantized as it is staged,
// rint(x / scale) clamped to +-qm. The (BM, K) codes never sit in shared
// memory whole (K = 14336 would need 229 KB at BM = 16).
template <typename T>
struct ActRaw {
  static constexpr int V = 16 / sizeof(T);  // elements in one 16-byte load

  template <int BM>
  __device__ static __forceinline__ void begin(const TileArgs& a,
                                               int64_t row0, int nrows,
                                               float* rs) {
    const T* x = static_cast<const T*>(a.x) + row0 * a.K;  // the tile's rows
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int r = warp; r < nrows; r += kThreads / 32) {
      const T* xr = x + r * a.K;
      float amax = 0.f;
      for (int c = lane * V; c < a.K; c += 32 * V) {
        const int4 raw = __ldg(reinterpret_cast<const int4*>(xr + c));
        const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < V; ++j) amax = nan_max(amax, fabsf(to_f32(v[j])));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      }
      if (lane == 0) rs[r] = (amax != amax ? amax : fmaxf(amax, 1e-8f)) / a.qm;
    }
    __syncthreads();
  }

  template <int BM>
  __device__ static __forceinline__ void stage(const TileArgs& a,
                                               int64_t row0, int nrows,
                                               int k0, int8_t (*As)[KPAD],
                                               const float* rs) {
    const T* x = static_cast<const T*>(a.x) + row0 * a.K;  // the tile's rows
    const float qm = a.qm;
    // BM rows x 128 codes, 16 codes a thread
    for (int i = threadIdx.x; i < BM * (KC / 16); i += kThreads) {
      const int r = i / (KC / 16), c = (i % (KC / 16)) * 16;
      uint32_t q[4] = {0u, 0u, 0u, 0u};
      if (r < nrows) {
        const float s = rs[r];
        const int4* src =
            reinterpret_cast<const int4*>(x + r * a.K + k0 + c);
#pragma unroll
        for (int h = 0; h < 16 / V; ++h) {
          const int4 raw = __ldg(src + h);
          const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const int idx = h * V + j;
            const float cq = fminf(fmaxf(rintf(to_f32(v[j]) / s), -qm), qm);
            q[idx / 4] |= (static_cast<uint32_t>(__float2int_rn(cq)) & 0xFFu)
                          << (8 * (idx % 4));
          }
        }
      }
      *reinterpret_cast<uint4*>(&As[r][c]) = make_uint4(q[0], q[1], q[2], q[3]);
    }
  }

  __device__ static __forceinline__ float factor(const TileArgs&, int64_t,
                                                 const float* rs, int r) {
    return rs[r];
  }
};

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <int BM, bool W4, class Scale, class Act>
__global__ void __launch_bounds__(kThreads) w4a8_kernel(const TileArgs a) {
  using Acc = typename Scale::Acc;
  using Value = typename Scale::Value;
  constexpr int WARPS_M = BM / 16;      // 1 (decode) or 4 (prefill)
  constexpr int WARPS_N = 4 / WARPS_M;  // 4 or 1
  constexpr int WN = BN / WARPS_N;      // columns per warp: 16 or 64
  constexpr int NF = WN / 8;            // m16n8 fragments per warp: 2 or 8

  __shared__ __align__(16) int8_t As[BM][KPAD];
  __shared__ __align__(16) int8_t Bs[BN][KPAD];
  __shared__ float row_scale[BM];

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
  const int8_t* w = a.w + static_cast<int64_t>(e) * (W4 ? K / 2 : K) * N;
  const Value* s = static_cast<const Value*>(a.s) +
                   static_cast<int64_t>(e) * (K / gs) * N;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, t = lane & 3;  // mma groupID / thread-in-group

  Act::template begin<BM>(a, trow0, nrows, row_scale);

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
    Act::template stage<BM>(a, trow0, nrows, k0, As, row_scale);
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
            const int v = __ldg(p + (int64_t)j * N);
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
            v4 |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + (int64_t)j * N)))
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
      uint32_t af[4];
      af[0] = *reinterpret_cast<const uint32_t*>(&As[ar][ks + t * 4]);
      af[1] = *reinterpret_cast<const uint32_t*>(&As[ar + 8][ks + t * 4]);
      af[2] = *reinterpret_cast<const uint32_t*>(&As[ar][ks + 16 + t * 4]);
      af[3] = *reinterpret_cast<const uint32_t*>(&As[ar + 8][ks + 16 + t * 4]);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int bn = wn * WN + f * 8 + g;
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(&Bs[bn][ks + t * 4]);
        b[1] = *reinterpret_cast<const uint32_t*>(&Bs[bn][ks + 16 + t * 4]);
        mma_s8(part[f], af, b);
      }
      const int kend = k0 + ks + 32;
      if (kend % gs == 0) {
        // a quantization group ends: the policy's group step
        const int grp = kend / gs - 1;
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const int n = n0 + wn * WN + f * 8 + t * 2;
          const Value* sg = s + (int64_t)grp * N;
          const Value s0 = n < N ? __ldg(sg + n) : Value(0);
          const Value s1 = n + 1 < N ? __ldg(sg + n + 1) : Value(0);
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

  // epilogue: the policy's output step with the per-row factor (divided by
  // the expert's alpha where one is given: sa / alpha, then ONE multiply,
  // the reference's op order); unrouted rows are written as exact zeros
  const int lr0 = wm * 16 + g, lr1 = lr0 + 8;  // rows within the tile
  const float ae = a.alpha != nullptr ? a.alpha[e] : 1.f;
  float f0 = 0.f, f1 = 0.f;
  if (lr0 < nrows) {
    f0 = Act::factor(a, trow0 + lr0, row_scale, lr0);
    if (a.alpha != nullptr) f0 = __fdiv_rn(f0, ae);
  }
  if (lr1 < nrows) {
    f1 = Act::factor(a, trow0 + lr1, row_scale, lr1);
    if (a.alpha != nullptr) f1 = __fdiv_rn(f1, ae);
  }
  float* o0 = a.out + (trow0 + lr0) * N;
  float* o1 = a.out + (trow0 + lr1) * N;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int n = n0 + wn * WN + f * 8 + t * 2;
    if (m0 + lr0 < C) {
      if (n < N) o0[n] = lr0 < nrows ? Scale::out(acc[f][0], f0) : 0.f;
      if (n + 1 < N) o0[n + 1] = lr0 < nrows ? Scale::out(acc[f][1], f0) : 0.f;
    }
    if (m0 + lr1 < C) {
      if (n < N) o1[n] = lr1 < nrows ? Scale::out(acc[f][2], f1) : 0.f;
      if (n + 1 < N) o1[n + 1] = lr1 < nrows ? Scale::out(acc[f][3], f1) : 0.f;
    }
  }
}

template <class Scale, class Act, int BM>
void w4a8_launch_bm(const TileArgs& a, int E, int w_bits, cudaStream_t st) {
  const dim3 grid((a.N + BN - 1) / BN, (a.C + BM - 1) / BM, E);
  if (w_bits == 4) {
    w4a8_kernel<BM, true, Scale, Act><<<grid, kThreads, 0, st>>>(a);
  } else {
    w4a8_kernel<BM, false, Scale, Act><<<grid, kThreads, 0, st>>>(a);
  }
}

// Checks what the kernel cannot take, picks the row tile, launches, and
// returns cudaGetLastError().
template <class Scale, class Act>
int w4a8_launch_act(const TileArgs& a, int E, int w_bits, int bm,
                    void* stream) {
  if ((w_bits != 4 && w_bits != 8) || a.K % KC != 0 || a.gs <= 0 ||
      a.gs % 32 != 0 || a.K % a.gs != 0 || E <= 0 || E > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.C > 0 && a.N > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (bm == 16) {
      w4a8_launch_bm<Scale, Act, 16>(a, E, w_bits, st);
    } else if (bm == 64) {
      w4a8_launch_bm<Scale, Act, 64>(a, E, w_bits, st);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The body of the dense GEMMs' C entry points: xq (M, K) int8 codes with
// the per-row factor fac (M,).
template <class Scale>
int w4a8_launch(const void* xq, const void* fac, const void* w, const void* s,
                void* out, int M, int N, int K, int gs, int w_bits, int bm,
                void* stream) {
  TileArgs a{xq, static_cast<const float*>(fac),
             static_cast<const int8_t*>(w), s, static_cast<float*>(out),
             nullptr, nullptr, M, N, K, gs, 0.f};
  return w4a8_launch_act<Scale, ActCodes>(a, 1, w_bits, bm, stream);
}

// The body of the grouped GEMMs' C entry points. x_kind: 0 = int8 codes
// with the per-row factor fac, 1 = raw bf16 rows, 2 = raw f32 rows (both
// quantized in the kernel to +-qm). counts (E,) int32 or null; alpha (E,)
// f32 or null.
template <class Scale>
int w4a8_grouped_launch(const void* x, int x_kind, const void* fac,
                        const void* alpha, const void* counts, const void* w,
                        const void* s, void* out, int E, int C, int N, int K,
                        int gs, int w_bits, int bm, float qm, void* stream) {
  TileArgs a{x, static_cast<const float*>(fac),
             static_cast<const int8_t*>(w), s, static_cast<float*>(out),
             static_cast<const int*>(counts),
             static_cast<const float*>(alpha), C, N, K, gs, qm};
  if (x_kind == 0) return w4a8_launch_act<Scale, ActCodes>(a, E, w_bits, bm, stream);
  if (x_kind == 1) {
    return w4a8_launch_act<Scale, ActRaw<__nv_bfloat16>>(a, E, w_bits, bm, stream);
  }
  if (x_kind == 2) return w4a8_launch_act<Scale, ActRaw<float>>(a, E, w_bits, bm, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
