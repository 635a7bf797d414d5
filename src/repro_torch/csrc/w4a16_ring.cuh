// The W4A16 loop shared by the dense weight-only GEMM (w4a16_gemm.cu) and
// the ragged batched-expert one (moe_w4a16.cu):
//
//   per expert e, row m < min(counts[e], C):
//   O = X_bf16 @ bf16(W_int4[e] * s_g[e])     (f32 accumulation over all K)
//   rows at or past the count: exact zeros
//
// The dense GEMM is the case E = 1, C = M, no counts.
//
// What bounds it on the H100: at decode (M <= 16, or Mixtral's capacity 8)
//   device-memory bytes: the packed int4 weights (K*N/2 bytes a matrix) and
//   f32 group scales, read once for a handful of rows (8.9 MB, 2.7 us at
//   3.35 TB/s, for 4096 -> 4096). At prefill (M = 128, capacity 40) bf16
//   tensor-core operations and bytes are of the same order. The per-weight
//   dequantization (int4 -> f32, times the scale, round to bf16) must stay
//   below the byte time.
// What the design does about it:
//   - Split K on 128-row packing-unit boundaries where the grid would
//     otherwise not fill the card (the wrapper's launch_plan picks the
//     split: about two blocks per SM; the experts count as blocks, so
//     Mixtral's grouped shapes run unsplit). Each split writes its partial
//     sums to an f32 workspace; a second small kernel adds the splits in a
//     fixed order, so the same inputs give the same bits on every launch
//     (no atomics, no host sync, no allocation here: the wrapper passes the
//     workspace).
//   - A ring of 4 shared-memory stages filled by 16-byte cp.async: per
//     packing unit, the raw packed bytes (64 rows x 64 columns, neighbouring
//     threads on neighbouring columns), the unit's f32 scale rows and its
//     bf16 activation rows (only the routed ones), so three units are in
//     flight while one is consumed.
//   - The weights are dequantized from the staged bytes straight into the
//     mma.sync m16n8k16 B fragments in registers: each thread reads four
//     32-bit words (rows r, r+1, r+8, r+9 of four neighbouring columns),
//     whose low nibbles are its fragment of k-step k and whose high nibbles
//     are that of k-step 64 + k. The fragment's column j of n8-fragment f is
//     physical column 4j + f of the warp's 32, so no byte moves between
//     threads. int4 -> f32 is exact with a magic exponent (one LOP3 and a
//     subtraction, no I2F), then __fmul_rn by the scale and round-to-nearest
//     to bf16: bit-identical to the plain version's dequantized weights.
//   - A fragments come through ldmatrix from the staged activation rows.
//     The row tile is 16 (decode) or 64 (above); every warp covers all rows
//     of the tile, so each weight is dequantized once per block. An m16
//     tile with no routed row (Mixtral's prefill capacity 40 in a 64-row
//     tile) runs its MMAs on zero rows: on the H100 a branch around them
//     made the kernel slower at every shape, the dense GEMM's too.
//   - Any N: when N % 16 != 0 the rows of packed bytes and scales are not
//     16-byte aligned, and an instance of the kernel stages them by plain
//     loads instead of cp.async (VEC = false), with element-wise stores.
//   - Four warps: two 32-column halves times two halves of the unit's k;
//     the two k-halves are added through shared memory at the end.
// Experts: blockIdx.z is (expert e, split); the expert's rows are rows
//   [e*C, e*C + C) of the (E*C, K) activations and output, its weights and
//   scales the e-th slabs, every base 64-bit. Only rows below
//   rc = min(counts[e], C) are routed; counts are read on the device (no
//   host sync, so a MoE step captures as a CUDA graph). A block whose
//   m-tile starts at or past rc writes zeros (into its split's slab, so the
//   reduction adds zeros) and returns; unrouted rows of an active tile are
//   written as exact zeros. Rows at or past C belong to the next expert
//   and are never touched.
// bf16 x bf16 products are exact in f32, so only the order of the f32 sum
//   differs from the plain version; the ragged entry equals the dense
//   grouped one bit for bit on zero-filled padding (the same blocks, the
//   same sums).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "tc_bf16.cuh"

namespace {

constexpr int BN = 64;         // output columns per block
constexpr int KU = 128;        // k per packing unit (core/packing.py)
constexpr int WARPS_N = BN / 32;         // 32-column slices of the tile
constexpr int kThreads = 64 * WARPS_N;   // x 2 halves of the unit's k
constexpr int STAGES = 4;      // shared-memory ring depth
constexpr int XS = KU + 8;     // bf16 row stride of a staged activation row
constexpr int WSB = BN + 16;   // byte row stride of the staged packed rows
constexpr int SROWS = 8;       // scale rows one unit can span (gs >= 16)

// Shared-memory layout for a row tile of BM: STAGES x (activations, packed
// weights, scale rows). The epilogue reuses the ring for the two k-halves'
// partial tiles.
template <int BM>
struct Smem {
  static constexpr int x = BM * XS * 2;
  static constexpr int w = (KU / 2) * WSB;
  static constexpr int s = SROWS * BN * 4;
  static constexpr int stage = x + w + s;
  static constexpr int ring = STAGES * stage;
  static constexpr int red = 2 * BM * BN * 4;
  static constexpr int bytes = ring > red ? ring : red;
};

// The signed nibble under MASK of v as an exact float: the nibble (xor 8)
// becomes the low mantissa bits of a float whose exponent (in magic) puts
// the nibble's lowest bit at 1, so subtracting the exponent's power of two
// plus 8 leaves the two's-complement value in [-8, 7]. One LOP3 computes
// (v & MASK) ^ magic; magic is a register the compiler cannot fold into a
// second immediate (see Magic), which would split it in two.
template <uint32_t MASK>
__device__ __forceinline__ float nibble(uint32_t v, uint32_t magic,
                                        float bias) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;" : "=r"(r) : "r"(v), "n"(MASK),
      "r"(magic));
  return __fsub_rn(__uint_as_float(r), bias);
}

// The four exponent-and-xor words of nibbles2, opaque to the compiler
struct Magic {
  uint32_t lo0, hi0, lo1, hi1;
  __device__ explicit Magic(uint32_t zero)  // zero: a runtime 0
      : lo0(0x4B000008u + zero), hi0(0x49000080u + zero),
        lo1(0x47000800u + zero), hi1(0x45008000u + zero) {}
};

// Low (k) and high (k + 64) nibble of bytes 0 and 1 of v, as floats
__device__ __forceinline__ void nibbles2(uint32_t v, const Magic& mg,
                                         float (&lo)[2], float (&hi)[2]) {
  lo[0] = nibble<0x0000000Fu>(v, mg.lo0, 8388616.f);  // 2^23 + 8
  hi[0] = nibble<0x000000F0u>(v, mg.hi0, 524296.f);   // 2^19 + 8
  lo[1] = nibble<0x00000F00u>(v, mg.lo1, 32776.f);    // 2^15 + 8
  hi[1] = nibble<0x0000F000u>(v, mg.hi1, 2056.f);     // 2^11 + 8
}

// bf16 pair (first in the low half) of c0 * s and c1 * s, each rounded
// from its f32 product to nearest even, as the plain version rounds
__device__ __forceinline__ uint32_t deq2(float c0, float c1, float s) {
  const __nv_bfloat162 h =
      __floats2bfloat162_rn(__fmul_rn(c0, s), __fmul_rn(c1, s));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// One block: a BM x BN output tile of expert e over the packing units
// [u0, u1) of its split. blockIdx = (n-block, m-block, e * splits + split).
// dst is out (one split) or the workspace (splits, E*C, N). VEC: N % 16 ==
// 0 (cp.async and float4 stores); else the plain-load path.
template <int BM, bool VEC>
__global__ void __launch_bounds__(kThreads, BM == 16 ? 512 / kThreads : 1)
w4a16_kernel(const __nv_bfloat16* __restrict__ x,
             const uint8_t* __restrict__ wq, const float* __restrict__ sc,
             float* __restrict__ dst, const int* __restrict__ counts, int E,
             int C, int N, int K, int gs, int splits) {
  using L = Smem<BM>;
  constexpr int MT = BM / 16;  // m16 tiles per warp
  extern __shared__ __align__(16) uint8_t smem[];

  const int units = K / KU;
  const int e = blockIdx.z / splits;
  const int z = blockIdx.z - e * splits;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  // this block's rows of its expert: [m0, m0 + wrows) written, the first
  // nrows of them routed
  const int wrows = C - m0 < BM ? C - m0 : BM;
  const int rc = routed_rows(counts, e, C);
  float* out = dst + (static_cast<int64_t>(z) * E + e) * C * N +
               static_cast<int64_t>(m0) * N;
  if (m0 >= rc) {  // no routed row in this m-tile: zeros
    for (int i = tid; i < wrows * BN; i += kThreads) {
      const int r = i / BN, c = i % BN;
      if (n0 + c < N) out[static_cast<int64_t>(r) * N + n0 + c] = 0.f;
    }
    return;
  }
  const int nrows = rc - m0 < BM ? rc - m0 : BM;
  const int u0 = static_cast<int>(static_cast<int64_t>(z) * units / splits);
  const int u1 =
      static_cast<int>(static_cast<int64_t>(z + 1) * units / splits);
  const int nu = u1 - u0;
  x += (static_cast<int64_t>(e) * C + m0) * K;
  wq += static_cast<int64_t>(e) * (K / 2) * N;
  sc += static_cast<int64_t>(e) * (K / gs) * N;

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma groupID / thread-in-group
  const int cg = warp % WARPS_N;           // 32-column slice of the tile
  const int kh = warp / WARPS_N;          // k-half: slabs 2kh, 2kh + 1

  // activation rows past the routed ones stay zero in every stage
  constexpr int XCH = XS * 2 / 16;  // 16-byte chunks of a staged row
  for (int i = tid; i < STAGES * BM * XCH; i += kThreads) {
    const int s = i / (BM * XCH), r = (i / XCH) % BM, c = i % XCH;
    if (r >= nrows) {
      *reinterpret_cast<int4*>(smem + s * L::stage + r * XS * 2 + c * 16) =
          make_int4(0, 0, 0, 0);
    }
  }

  // This thread's copies, the same in every unit: WCH 16-byte chunks of
  // packed weights (rows wr + j * kThreads / (BN / 16), columns wc..wc+15),
  // a chunk of scale row sr of the unit (columns scc..scc+3), and up to XCP
  // chunks of activations. The groups are tracked incrementally: the unit
  // loaded next starts at k = 128 u = lg * gs + lr, the one computed next
  // at a k whose remainder by gs is crr.
  constexpr int WCH = (KU / 2) * (BN / 16) / kThreads;
  constexpr int XCP = (BM * (KU / 8) + kThreads - 1) / kThreads;
  const int wr = tid / (BN / 16), wc = (tid % (BN / 16)) * 16;
  const bool win = n0 + wc < N;
  const uint8_t* wsrc = wq + static_cast<int64_t>(u0) * (KU / 2) * N +
                        static_cast<int64_t>(wr) * N + (win ? n0 + wc : 0);
  const int sr = tid / (BN / 4), scc = (tid % (BN / 4)) * 4;
  const bool sin = n0 + scc < N;
  const float inv_gs = 1.f / static_cast<float>(gs);
  const int q128 = KU / gs, r128 = KU % gs;  // 128 = q128 * gs + r128
  int lg = static_cast<int>(static_cast<int64_t>(u0) * KU / gs);
  int lr = static_cast<int>(static_cast<int64_t>(u0) * KU % gs);
  int crr = lr;
  int lu = u0;  // the unit to load next

  // stage s <- the next packing unit
  auto load = [&](int s) {
    uint8_t* xs = smem + s * L::stage;
    uint8_t* ws = xs + L::x;
    float* ss = reinterpret_cast<float*>(ws + L::w);
#pragma unroll
    for (int j = 0; j < WCH; ++j) {
      uint8_t* d = ws + (wr + j * (kThreads / (BN / 16))) * WSB + wc;
      const uint8_t* src =
          wsrc + static_cast<int64_t>(j) * (kThreads / (BN / 16)) * N;
      if constexpr (VEC) {
        cp16(d, src, win);
      } else {
        copy16_tail(d, src, N - n0 - wc);
      }
    }
    wsrc += static_cast<int64_t>(KU / 2) * N;
    if (sr <= div_small(lr + KU - 1, inv_gs)) {  // rows lg .. (last k) / gs
      float* d = ss + sr * BN + scc;
      const float* src =
          sc + static_cast<int64_t>(lg + sr) * N + (sin ? n0 + scc : 0);
      if constexpr (VEC) {
        cp16(d, src, sin);
      } else {
        copy16_tail(d, src, N - n0 - scc);
      }
    }
#pragma unroll
    for (int j = 0; j < XCP; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (KU / 8), c = (i % (KU / 8)) * 8;
      if (r < nrows) {
        cp16(xs + (r * XS + c) * 2,
             x + static_cast<int64_t>(r) * K + lu * KU + c, true);
      }
    }
    ++lu;
    lg += q128;
    lr += r128;
    if (lr >= gs) {
      lr -= gs;
      ++lg;
    }
  };

  const Magic mg(static_cast<uint32_t>(gs) >> 31);  // gs > 0: zero
  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][f][i] = 0.f;

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nu) load(s);
    cp_commit();
  }

  for (int it = 0; it < nu; ++it) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // unit it has landed; stage (it - 1) % STAGES is free
    if (it + STAGES - 1 < nu) load((it + STAGES - 1) % STAGES);
    cp_commit();

    const int s = it % STAGES;
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(smem + s * L::stage);
    const uint8_t* ws = smem + s * L::stage + L::x;
    const float* ss = reinterpret_cast<const float*>(ws + L::w);
    // scale rows of this warp's k-steps, relative to the unit's first
    int rel[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      rel[h] = div_small(crr + 16 * (2 * kh + (h & 1)) + (h >> 1) * (KU / 2),
                         inv_gs);
    }
    crr += r128;
    if (crr >= gs) crr -= gs;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int sl = 2 * kh + h;  // k-steps 16 sl (low) and 64 + 16 sl (high)
      const uint8_t* wp = ws + (16 * sl + 2 * t) * WSB + cg * 32 + 4 * g;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wp);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wp + WSB);
      const uint32_t w2 = *reinterpret_cast<const uint32_t*>(wp + 8 * WSB);
      const uint32_t w3 = *reinterpret_cast<const uint32_t*>(wp + 9 * WSB);
      const float4 slo = *reinterpret_cast<const float4*>(
          ss + rel[h] * BN + cg * 32 + 4 * g);
      const float4 shi = *reinterpret_cast<const float4*>(
          ss + rel[2 + h] * BN + cg * 32 + 4 * g);
      const float sl4[4] = {slo.x, slo.y, slo.z, slo.w};
      const float sh4[4] = {shi.x, shi.y, shi.z, shi.w};

      // B fragments of the four n8-fragments: byte f of each word
      uint32_t blo[4][2], bhi[4][2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // bytes 0-1, then 2-3
        const int sh = 16 * half;
        float l0[2], h0[2], l1[2], h1[2], l2[2], h2[2], l3[2], h3[2];
        nibbles2(w0 >> sh, mg, l0, h0);
        nibbles2(w1 >> sh, mg, l1, h1);
        nibbles2(w2 >> sh, mg, l2, h2);
        nibbles2(w3 >> sh, mg, l3, h3);
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int f = 2 * half + b;
          blo[f][0] = deq2(l0[b], l1[b], sl4[f]);
          blo[f][1] = deq2(l2[b], l3[b], sl4[f]);
          bhi[f][0] = deq2(h0[b], h1[b], sh4[f]);
          bhi[f][1] = deq2(h2[b], h3[b], sh4[f]);
        }
      }

#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* ap =
            xs + (mt * 16 + (lane & 15)) * XS + 16 * sl + (lane >> 4) * 8;
        uint32_t alo[4], ahi[4];
        ldmatrix_x4(alo, ap);
        ldmatrix_x4(ahi, ap + KU / 2);
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          mma_bf16(acc[mt][f], alo, blo[f][0], blo[f][1]);
          mma_bf16(acc[mt][f], ahi, bhi[f][0], bhi[f][1]);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the partial tiles

  // red[kh][row][col]: fragment column j of n8-fragment f is tile column
  // cg * 32 + 4 j + f
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = mt * 16 + g + (i >> 1) * 8;
        const int c = cg * 32 + 4 * (2 * t + (i & 1)) + f;
        red[(kh * BM + r) * BN + c] = acc[mt][f][i];
      }
    }
  }
  __syncthreads();
  // the written rows: the routed ones' sums, exact zeros below them
  for (int i = tid; i < wrows * (BN / 4); i += kThreads) {
    const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
    if (n0 + c >= N) continue;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows) {
      const float4 a = *reinterpret_cast<const float4*>(&red[r * BN + c]);
      const float4 b =
          *reinterpret_cast<const float4*>(&red[(BM + r) * BN + c]);
      v = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
    }
    float* o = &out[static_cast<int64_t>(r) * N + n0 + c];
    if constexpr (VEC) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      const float e4[4] = {v.x, v.y, v.z, v.w};
      for (int j = 0; j < 4 && n0 + c + j < N; ++j) o[j] = e4[j];
    }
  }
}

__device__ __forceinline__ void add_to(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ void add_to(float& a, float b) { a += b; }

// out[i] = ws[0][i] + ws[1][i] + ... + ws[splits - 1][i], in that order;
// T is float4 where the slab size is a multiple of 4 (every slab 16-byte
// aligned), else float
template <typename T>
__global__ void __launch_bounds__(256)
splitk_reduce(const T* __restrict__ ws, T* __restrict__ out, int splits,
              int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n) return;
  T a = ws[i];
  for (int s = 1; s < splits; ++s) add_to(a, ws[s * n + i]);
  out[i] = a;
}

template <typename T>
cudaError_t reduce(const void* ws, void* out, int splits, int64_t elems,
                   cudaStream_t st) {
  const int64_t n = elems * sizeof(float) / sizeof(T);
  splitk_reduce<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      static_cast<const T*>(ws), static_cast<T*>(out), splits, n);
  return cudaGetLastError();
}

template <int BM, bool VEC>
cudaError_t launch(const __nv_bfloat16* x, const int* counts,
                   const uint8_t* w, const float* s, float* dst, int E,
                   int C, int N, int K, int gs, int splits,
                   cudaStream_t st) {
  constexpr int bytes = Smem<BM>::bytes;
  static bool attr[64] = {};
  cudaError_t err = allow_smem(w4a16_kernel<BM, VEC>, bytes, attr);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (C + BM - 1) / BM, E * splits);
  w4a16_kernel<BM, VEC><<<grid, kThreads, bytes, st>>>(
      x, w, s, dst, counts, E, C, N, K, gs, splits);
  return cudaGetLastError();
}

// The body of both C entry points. x (E*C, K) bf16; counts (E,) int32 or
// null (every row routed); w (E, K/2, N) packed int4; s (E, K/gs, N) f32;
// out (E*C, N) f32; ws (splits, E*C, N) f32 when splits > 1 (else
// unused). All contiguous and 16-byte aligned. K % 128 == 0, K % gs == 0,
// gs % 16 == 0, any N >= 1, 1 <= splits <= K / 128, E * splits <= 65535;
// bm is 16 or 64. Launches the tile kernel and, when splits > 1, the
// fixed-order reduction of the splits into out. Returns cudaGetLastError()
// after the launches.
inline int w4a16_launch(const void* x, const void* counts, const void* w,
                        const void* s, void* out, void* ws, int E, int C,
                        int N, int K, int gs, int bm, int splits,
                        void* stream) {
  if (K % KU != 0 || gs <= 0 || gs % 16 != 0 || K % gs != 0 || splits < 1 ||
      splits > K / KU || (splits > 1 && ws == nullptr) || E < 1 ||
      static_cast<int64_t>(E) * splits > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (C <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* cn = static_cast<const int*>(counts);
  const auto* wb = static_cast<const uint8_t*>(w);
  const auto* sf = static_cast<const float*>(s);
  float* dst = static_cast<float*>(splits > 1 ? ws : out);
  const bool vec = N % 16 == 0;
  cudaError_t err;
  if (bm == 16) {
    err = vec ? launch<16, true>(xb, cn, wb, sf, dst, E, C, N, K, gs, splits,
                                 st)
              : launch<16, false>(xb, cn, wb, sf, dst, E, C, N, K, gs,
                                  splits, st);
  } else if (bm == 64) {
    err = vec ? launch<64, true>(xb, cn, wb, sf, dst, E, C, N, K, gs, splits,
                                 st)
              : launch<64, false>(xb, cn, wb, sf, dst, E, C, N, K, gs,
                                  splits, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t elems = static_cast<int64_t>(E) * C * N;
  return static_cast<int>(elems % 4 == 0
                              ? reduce<float4>(ws, out, splits, elems, st)
                              : reduce<float>(ws, out, splits, elems, st));
}

}  // namespace
