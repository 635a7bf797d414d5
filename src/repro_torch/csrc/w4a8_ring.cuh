// The loop of the W4A8 / W8A8 GEMMs: Integer Scale (paper Eq. 2) and float
// scale (Eq. 1, fine and coarse), dense (w4a8_gemm_is.cu, w4a8_gemm_fs.cu)
// and ragged batched-expert (moe_w4a8_is.cu, moe_w4a8_fs.cu), the same
// template under the two Scale policies of w4a8_common.cuh, so a time
// difference between IS and FS measures only the per-group step and the
// epilogue (the paper's Table 3 comparison, and §5.5's on Mixtral).
//
//   per expert e, row m < rc = min(counts[e], C):
//   O[m, n] = out(sum over groups g of group(part_g[m, n], s[g, n]), f[m])
//   part_g = sum over k in g of xq[m, k] * w[k, n]        (int32)
//   f[m] = sa[m] / alpha[e] (Integer Scale) or sa[m] (float scale)
//   rows at or past rc: exact +0.0
//
// The dense GEMMs are the case E = 1, C = M, no counts.
//
// What bounds it on the H100: at decode (M <= 16) device-memory bytes: the
//   packed int4 weights (K*N/2 bytes) and the 4-byte group scales
//   (4*K*N/gs), read once for a handful of rows (2.7 us at 3.35 TB/s for
//   4096 -> 4096). At prefill (M = 128) int8 tensor-core operations and
//   bytes are of the same order. The unpacking of the weights into MMA
//   operands must stay below the byte time.
// What the design does about it (second design; the first, w4a8_tile.cuh,
//   now deleted, ran 64 blocks at N = 4096, read one byte per load,
//   unpacked through shared memory and, in the grouped kernels, quantized
//   the activations again in every n-block):
//   - Split K on 128-row packing-unit boundaries where the grid would not
//     fill the card (the wrapper's launch_plan, shared with the W4A16 GEMM:
//     about two blocks per SM). Each split writes 4-byte partials to a
//     workspace and a second small kernel adds the splits in split order
//     and applies the epilogue, so a launch is deterministic (no atomics,
//     no host sync, no allocation here).
//   - A ring of 4 shared-memory stages filled by 16-byte cp.async: per
//     packing unit the raw packed bytes (64 rows x 64 columns; W8: 128 rows
//     of int8), the unit's scale rows and the int8 activation rows, so three
//     units are in flight while one is consumed. The per-row factor is
//     formed once, in the epilogue: sa / alpha[e] by one IEEE division
//     (__fdiv_rn), then ONE multiply, the reference's op order (its ragged
//     kernel's epilogue, src/repro/kernels/moe_gemm.py), so the activation
//     codes and scales that act_quant.cu writes serve every GEMM that reads
//     the same activation, whatever its amplifier.
//   - The weights become the mma.sync m16n8k32 s8 B fragments in registers,
//     with no unpacking through shared memory. A thread reads four 32-bit
//     words (rows r..r+3 of four neighbouring columns) and transposes them
//     with four byte permutes pairwise twice (8 PRMT for 16 bytes), so byte
//     i of word f holds row r + i of column f: fragment column j of
//     n8-fragment f is physical column 4j + f of the warp's 32, as in the
//     W4A16 loop. W4: a packed byte holds k (low nibble) and k + 64 (high
//     nibble) of one column; v & 0xF0F0F0F0 is 16 x the signed high nibbles
//     as int8 bytes and (v << 4) & 0xF0F0F0F0 is 16 x the signed low ones,
//     so one transposed word serves two k-steps at 1 and 2 instructions.
//     The MMA's int32 partial is then exactly 16 x the true one, and an
//     arithmetic >> 4 before the group step restores it. It cannot
//     overflow: |16 w| <= 128 and |x| <= 128, so a partial over r rows of k
//     stays below r * 2^14, and a partial never spans more than one group
//     (gs <= 2^16, refused above: below 2^30).
//   - Shared-memory rows of packed bytes are 80 bytes apart and the two
//     16-byte halves of each 32-byte warp slice trade places in every other
//     group of 8 rows, so the 32 words a warp reads at once fall in 32
//     banks. A fragments come through ldmatrix (144-byte activation rows).
//   - Four warps: two 32-column halves times two halves of the unit's k
//     (warp kh takes k-steps 32 kh and 64 + 32 kh; the k-halves are added
//     through shared memory at the end) or, at prefill (BM = 64), two
//     32-row halves (every warp takes all four k-steps, so each holds half
//     the accumulators and three blocks fit an SM; each weight is unpacked
//     twice, by both row halves). See Warps.
// The group step, and why the splits are exact:
//   - Each warp steps its own partial into its accumulator when the group
//     of its next k-step (64 on with two k-halves, else 32) differs, and
//     at the end of its split. The IS step
//     acc += part * s is linear in int32 arithmetic mod 2^32, so summing
//     the k-halves' and the splits' accumulators (int32, wrapping) gives
//     exactly the plain version's int32 sum, for any group size, also one
//     that a split's range cuts: IS is bit-exact at every split count.
//   - FS fine: the f32 terms of a group's two k-halves are added after
//     their products, and the splits' f32 sums in split order: the same
//     terms in another order than torch.sum, held to rtol 1e-5 / atol 1e-4.
//   - One group over all of K (gs == K; coarse FS): no step in the loop.
//     The int32 partials of the k-halves and the splits are summed first,
//     then the single group step and the epilogue run, in the last kernel:
//     (float(P) * s[n]) * sa[m], the plain arithmetic exactly: bit-exact.
// Any N: when N % 16 != 0 the rows of bytes and scales are not 16-byte
//   aligned, and an instance stages them by plain loads (VEC = false).
// Experts: blockIdx.z is (expert e, split), as in w4a16_ring.cuh; the
//   expert's rows are rows [e*C, e*C + C) of the (E*C, K) codes, their
//   scales and the output, its weights and scales the e-th slabs. Its
//   offsets are 32-bit row indices (E*C rows, E*K/gs scale rows) times
//   64-bit strides, as the dense loop indexed its operands. The expert
//   dimension is a template flag (GROUPED): the dense entry points compile
//   it away, because on the H100 its runtime arithmetic and 64-bit bases
//   cost the dense GEMMs up to 12 registers and 2-9 % of their time. The
//   codes come quantized (act_quant.cu's routed entry, once per shared
//   activation), so the loop reads int8 rows as the dense GEMMs do. Only
//   rows below rc are routed; counts are read on the device (no host sync,
//   so a MoE step captures as a CUDA graph). A block whose m-tile starts at
//   or past rc writes zeros (into out, or into its split's slab) and
//   returns; the routed rows' zero tail of a live tile is written as +0.0
//   without reading its factor, and the split reduction writes +0.0 at every
//   row at or past rc, so nothing a buffer holds past the counts (NaN, inf)
//   reaches the output. Rows at or past C belong to the next expert and are
//   never touched.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"
#include "w4a8_common.cuh"

namespace {

constexpr int BN = 64;         // output columns per block
constexpr int KU = 128;        // k per packing unit (core/packing.py)
constexpr int WARPS_N = BN / 32;         // 32-column slices of the tile
constexpr int kThreads = 64 * WARPS_N;   // x 2 halves of the unit's k
constexpr int STAGES = 4;      // shared-memory ring depth
constexpr int XS = KU + 16;    // byte stride of a staged activation row
constexpr int WSB = BN + 16;   // byte stride of a staged weight row
constexpr int SROWS = 4;       // scale rows one unit can span (gs >= 32)
constexpr int MAX_GS = 1 << 16;  // group bound of the x16 partials

// How the four warps share a BM x 64 tile: two 32-column halves times, at
// BM = 16, two halves of each unit's k (KW = 2: warp kh takes k-steps
// 32 kh and 64 + 32 kh) or, at BM = 64, two 32-row halves (KW = 1: every
// warp takes all four k-steps of its rows; half the accumulator registers
// a warp, so three blocks fit an SM, which on the H100 was faster than
// k-halves at the prefill shapes).
template <int BM>
struct Warps {
  static constexpr int KW = BM == 16 ? 2 : 1;  // warps along k
  static constexpr int MT = BM / 16 / (2 / KW);  // m16 tiles per warp
  static constexpr int KS = 4 / KW;             // k-steps per warp and unit
};

// Shared-memory layout for a row tile of BM: STAGES x (activations, weight
// rows, scale rows). The epilogue reuses the ring for the k-halves.
template <int BM, bool W4>
struct Smem {
  static constexpr int x = BM * XS;
  static constexpr int w = (W4 ? KU / 2 : KU) * WSB;
  static constexpr int s = SROWS * BN * 4;
  static constexpr int stage = x + w + s;
  static constexpr int ring = STAGES * stage;
  static constexpr int red = Warps<BM>::KW * BM * BN * 4;
  static constexpr int bytes = ring > red ? ring : red;
};

// Byte offset of 16-byte chunk c (of 4) of staged weight row r
__device__ __forceinline__ int wchunk(int r, int c) {
  return r * WSB + ((c ^ (((r >> 3) & 1) << 1)) << 4);
}

// Rows r..r+3 of four neighbouring columns (one word each) -> four words,
// word f holding column f of rows r..r+3 in bytes 0..3
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4],
                                           uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

// The four words of a warp's read: rows r0 + i (i < 4) at this thread's
// byte column bc (a multiple of 4) of the staged weights ws
__device__ __forceinline__ void read4(const uint8_t* ws, int r0, int bc,
                                      uint32_t (&w)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + i;
    w[i] = *reinterpret_cast<const uint32_t*>(ws + wchunk(r, bc >> 4) +
                                              (bc & 15));
  }
}

// What is stored per output between the kernels: the accumulator, or for
// one group over all of K (DEFER) the raw int32 partial
template <class Scale, bool DEFER>
using Part = typename std::conditional<DEFER, int, typename Scale::Acc>::type;

__device__ __forceinline__ int add_p(int a, int b) {  // wraps, as int32
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b));
}
__device__ __forceinline__ float add_p(float a, float b) {
  return __fadd_rn(a, b);
}

// The output of column n from its summed partial and its row's factor f;
// s is the expert's one scale row, which only DEFER reads
template <class Scale, bool DEFER>
__device__ __forceinline__ float finish(Part<Scale, DEFER> p,
                                        const typename Scale::Value* s,
                                        float f, int n) {
  if constexpr (DEFER) {
    return Scale::out(Scale::group(typename Scale::Acc(0), p, s[n]), f);
  } else {
    return Scale::out(p, f);
  }
}

// The epilogue's factor of row `row` of expert e: its activation scale
// divided by the expert's amplifier (Integer Scale; an IEEE division, as the
// plain version's sa / alpha) or the scale itself (float scale: no alpha)
__device__ __forceinline__ float row_factor(const float* sa,
                                            const float* alpha, int64_t row,
                                            int e) {
  const float s = sa[row];
  return alpha != nullptr ? __fdiv_rn(s, alpha[e]) : s;
}

// One block: a BM x BN output tile of expert e over the packing units
// [u0, u1) of its split. blockIdx = (n-block, m-block, e * splits + split).
// With one split the block writes out; else its Part sums go to the
// split's (E*C, N) slab of ws. !GROUPED: E = 1 and no counts.
template <int BM, bool W4, bool VEC, class Scale, bool DEFER, bool GROUPED>
__global__ void __launch_bounds__(kThreads, BM == 16 ? 512 / kThreads : 3)
w4a8_ring_kernel(const int8_t* __restrict__ x, const float* __restrict__ sa,
                 const float* __restrict__ alpha,
                 const uint8_t* __restrict__ wq, const void* __restrict__ sc,
                 float* __restrict__ out, void* __restrict__ ws,
                 const int* __restrict__ counts, int E, int C, int N, int K,
                 int gs, int splits) {
  using L = Smem<BM, W4>;
  using Acc = typename Scale::Acc;
  using Value = typename Scale::Value;
  using P = Part<Scale, DEFER>;
  constexpr int KW = Warps<BM>::KW, MT = Warps<BM>::MT, KS = Warps<BM>::KS;
  constexpr int WROWS = W4 ? KU / 2 : KU;  // staged weight rows per unit
  constexpr int SH = W4 ? 4 : 0;       // the x16 of the nibble unpack
  extern __shared__ __align__(16) uint8_t smem[];

  const int units = K / KU;
  const int e = GROUPED ? static_cast<int>(blockIdx.z) / splits : 0;
  const int z = static_cast<int>(blockIdx.z) - e * splits;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  // this block's rows of its expert: [m0, m0 + wrows) written, the first
  // nrows of them routed; row0 is the first one's row of the E*C (the
  // expert's offsets are folded into 32-bit row indices, as the dense
  // loop indexed its operands, so no 64-bit base stays live in the loop)
  const int wrows = C - m0 < BM ? C - m0 : BM;
  const int rc = GROUPED ? routed_rows(counts, e, C) : C;
  const int row0 = e * C + m0;
  // the element of out (one split) or of the split's slab of ws where the
  // tile's first row starts
  auto at0 = [&]() {
    const int64_t rows = static_cast<int64_t>(GROUPED ? E : 1) * C;
    return (splits == 1 ? row0 : z * rows + row0) * static_cast<int64_t>(N);
  };
  if (m0 >= rc) {  // no routed row in this m-tile: zeros (+0.0 or int 0)
    uint32_t* d =
        static_cast<uint32_t*>(splits == 1 ? static_cast<void*>(out) : ws) +
        at0();
    for (int i = tid; i < wrows * BN; i += kThreads) {
      const int r = i / BN, c = i % BN;
      if (n0 + c < N) d[static_cast<int64_t>(r) * N + n0 + c] = 0u;
    }
    return;
  }
  const int nrows = rc - m0 < BM ? rc - m0 : BM;
  const int u0 = static_cast<int>(static_cast<int64_t>(z) * units / splits);
  const int u1 =
      static_cast<int>(static_cast<int64_t>(z + 1) * units / splits);
  const int nu = u1 - u0;

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma groupID / thread-in-group
  const int cg = warp % WARPS_N;           // 32-column slice of the tile
  const int kh = KW == 2 ? warp / WARPS_N : 0;  // k-half
  const int r0 = KW == 2 ? 0 : (warp / WARPS_N) * MT * 16;  // first row

  // activation rows past the routed ones stay zero in every stage
  constexpr int XCH = XS / 16;  // 16-byte chunks of a staged row
  for (int i = tid; i < STAGES * BM * XCH; i += kThreads) {
    const int s = i / (BM * XCH), r = (i / XCH) % BM, c = i % XCH;
    if (r >= nrows) {
      *reinterpret_cast<int4*>(smem + s * L::stage + r * XS + c * 16) =
          make_int4(0, 0, 0, 0);
    }
  }

  // This thread's copies, the same in every unit: WCH 16-byte chunks of
  // weight rows (rows wr + j * kThreads / 4, chunk wc), a chunk of scale
  // row sr of the unit (columns scc..scc+3), and up to XCP chunks of
  // activation rows. Groups are tracked incrementally: the unit loaded
  // next starts at k = 128 u = lg * gs + lr, the one computed next at a k
  // whose remainder by gs is crr.
  constexpr int WCH = WROWS * (BN / 16) / kThreads;
  constexpr int XCP = (BM * (KU / 16) + kThreads - 1) / kThreads;
  const int wr = tid / (BN / 16), wc = tid % (BN / 16);
  const bool win = n0 + wc * 16 < N;
  const uint8_t* wsrc =
      wq + (static_cast<int64_t>(e) * (K / KU) + u0) * WROWS * N +
      static_cast<int64_t>(wr) * N + (win ? n0 + wc * 16 : 0);
  const int sr = tid / (BN / 4), scc = (tid % (BN / 4)) * 4;
  const bool sin = n0 + scc < N;
  const float inv_gs = 1.f / static_cast<float>(gs);
  const int q128 = KU / gs, r128 = KU % gs;  // 128 = q128 * gs + r128
  // lg counts scale rows from the expert's first (K / gs rows an expert)
  int lg = e * (K / gs) +
           static_cast<int>(static_cast<int64_t>(u0) * KU / gs);
  int lr = static_cast<int>(static_cast<int64_t>(u0) * KU % gs);
  int crr = lr;
  int lu = u0;  // the unit to load next

  // stage s <- the next packing unit
  auto load = [&](int s) {
    uint8_t* xs = smem + s * L::stage;
    uint8_t* wst = xs + L::x;
#pragma unroll
    for (int j = 0; j < WCH; ++j) {
      const int r = wr + j * (kThreads / (BN / 16));
      uint8_t* d = wst + wchunk(r, wc);
      const uint8_t* src =
          wsrc + static_cast<int64_t>(j) * (kThreads / (BN / 16)) * N;
      if constexpr (VEC) {
        cp16(d, src, win);
      } else {
        copy16_tail(d, src, N - n0 - wc * 16);
      }
    }
    wsrc += static_cast<int64_t>(WROWS) * N;
    if constexpr (!DEFER) {
      if (sr < SROWS && sr <= div_small(lr + KU - 1, inv_gs)) {
        // rows lg .. (the unit's last k) / gs
        Value* d = reinterpret_cast<Value*>(wst + L::w) + sr * BN + scc;
        const Value* src = static_cast<const Value*>(sc) +
                           static_cast<int64_t>(lg + sr) * N +
                           (sin ? n0 + scc : 0);
        if constexpr (VEC) {
          cp16(d, src, sin);
        } else {
          copy16_tail(d, src, N - n0 - scc);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < XCP; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (KU / 16), c = (i % (KU / 16)) * 16;
      if (r < nrows && i < BM * (KU / 16)) {
        cp16(xs + r * XS + c,
             x + static_cast<int64_t>(row0 + r) * K + lu * KU + c, true);
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

  Acc acc[MT][4][4];
  int part[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[mt][f][i] = Acc(0);
        part[mt][f][i] = 0;
      }

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nu) load(s);
    cp_commit();
  }

  const int bc = cg * 32 + 4 * g;  // this thread's byte column of a row
  for (int it = 0; it < nu; ++it) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // unit it has landed; stage (it - 1) % STAGES is free
    if (it + STAGES - 1 < nu) load((it + STAGES - 1) % STAGES);
    cp_commit();

    const int s = it % STAGES;
    const uint8_t* xs = smem + s * L::stage;
    const uint8_t* wst = xs + L::x;
    const Value* ss = reinterpret_cast<const Value*>(wst + L::w);

    // W4: k-step ka comes from packed rows 32 sl .. +31, sl = ka % 64 / 32
    // (low nibbles below k = 64, high ones above): the warp's slabs,
    // transposed once for both
    uint32_t pk[2 / KW][2][4];
    if constexpr (W4) {
#pragma unroll
      for (int j = 0; j < 2 / KW; ++j) {
        uint32_t w[4];
        read4(wst, 32 * (kh + j) + 4 * t, bc, w);
        transpose4(w, pk[j][0]);
        read4(wst, 32 * (kh + j) + 16 + 4 * t, bc, w);
        transpose4(w, pk[j][1]);
      }
    }
#pragma unroll
    for (int h = 0; h < KS; ++h) {
      const int ka = 32 * kh + 32 * KW * h;  // the k-step's first k
      uint32_t b[2][4];                      // (b0 | b1) x n8-fragment
      if constexpr (W4) {
        const int j = KW == 2 ? 0 : h & 1;  // the slab
#pragma unroll
        for (int f = 0; f < 4; ++f) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            b[i][f] = (ka < 64 ? pk[j][i][f] << 4 : pk[j][i][f]) &
                      0xF0F0F0F0u;
          }
        }
      } else {
        uint32_t w[4];
        read4(wst, ka + 4 * t, bc, w);
        transpose4(w, b[0]);
        read4(wst, ka + 16 + 4 * t, bc, w);
        transpose4(w, b[1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];  // unrouted rows are zeros in the stage
        ldmatrix_x4(a, xs + (r0 + mt * 16 + (lane & 15)) * XS + ka +
                           (lane >> 4) * 16);
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const uint32_t bf[2] = {b[0][f], b[1][f]};
          mma_s8(part[mt][f], a, bf);
        }
      }
      if constexpr (!DEFER) {
        // the group step when this warp's next k-step (32 KW on) is in
        // another group, or the split ends
        const int grp = div_small(crr + ka, inv_gs);
        if (grp != div_small(crr + ka + 32 * KW, inv_gs) ||
            (h == KS - 1 && it == nu - 1)) {
          const Value* sp = ss + grp * BN + cg * 32 + 8 * t;
          alignas(16) Value sv[8];
          *reinterpret_cast<int4*>(&sv[0]) =
              *reinterpret_cast<const int4*>(sp);
          *reinterpret_cast<int4*>(&sv[4]) =
              *reinterpret_cast<const int4*>(sp + 4);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int f = 0; f < 4; ++f) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                // columns 8t + f (i even) and 8t + 4 + f (i odd)
                acc[mt][f][i] = Scale::group(acc[mt][f][i],
                                             part[mt][f][i] >> SH,
                                             sv[(i & 1) * 4 + f]);
                part[mt][f][i] = 0;
              }
            }
          }
        }
      }
    }
    crr += r128;
    if (crr >= gs) crr -= gs;
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the k-halves

  // red[kh][row][col]: fragment column j of n8-fragment f is tile column
  // cg * 32 + 4 j + f
  P* red = reinterpret_cast<P*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + mt * 16 + g + (i >> 1) * 8;
        const int c = cg * 32 + 4 * (2 * t + (i & 1)) + f;
        P v;
        if constexpr (DEFER) {
          v = part[mt][f][i] >> SH;
        } else {
          v = acc[mt][f][i];
        }
        red[(kh * BM + r) * BN + c] = v;
      }
    }
  }
  __syncthreads();
  const int64_t base = at0();
  // DEFER's one scale row of the expert (gs == K)
  const Value* srow =
      static_cast<const Value*>(sc) + static_cast<int64_t>(e) * N;
  for (int i = tid; i < wrows * (BN / 4); i += kThreads) {
    const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
    if (n0 + c >= N) continue;
    const bool live = !GROUPED || r < nrows;  // routed (else +0.0)
    const float f = live ? row_factor(sa, alpha, row0 + r, e) : 0.f;
    float o[4];
    alignas(16) P v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      P a = red[r * BN + c + j];
      if constexpr (KW == 2) a = add_p(a, red[(BM + r) * BN + c + j]);
      v[j] = live ? a : P(0);
      o[j] = live && splits == 1 && n0 + c + j < N
                 ? finish<Scale, DEFER>(a, srow, f, n0 + c + j)
                 : 0.f;
    }
    const int64_t o0 = base + static_cast<int64_t>(r) * N + n0 + c;
    if (splits == 1) {
      if constexpr (VEC) {
        *reinterpret_cast<float4*>(out + o0) =
            make_float4(o[0], o[1], o[2], o[3]);
      } else {
        for (int j = 0; j < 4 && n0 + c + j < N; ++j) out[o0 + j] = o[j];
      }
    } else {
      P* slab = static_cast<P*>(ws);
      if constexpr (VEC) {
        *reinterpret_cast<int4*>(slab + o0) =
            *reinterpret_cast<const int4*>(v);
      } else {
        for (int j = 0; j < 4 && n0 + c + j < N; ++j) slab[o0 + j] = v[j];
      }
    }
  }
}

// out[i] = finish(ws[0][i] + ws[1][i] + ... + ws[splits - 1][i]), the
// splits added in that order, over the n = E*C*N outputs; +0.0 at every row
// at or past its expert's count (whatever the slabs hold there)
template <class Scale, bool DEFER, bool GROUPED>
__global__ void __launch_bounds__(256)
w4a8_splitk_reduce(const Part<Scale, DEFER>* __restrict__ ws,
                   const void* __restrict__ sc, const float* __restrict__ sa,
                   const float* __restrict__ alpha,
                   float* __restrict__ out, const int* __restrict__ counts,
                   int C, int N, int64_t n, int splits) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n) return;
  const int row = static_cast<int>(i / N), col = static_cast<int>(i % N);
  const int e = GROUPED ? row / C : 0;
  if (GROUPED && row - e * C >= routed_rows(counts, e, C)) {
    out[i] = 0.f;
    return;
  }
  Part<Scale, DEFER> a = ws[i];
  for (int s = 1; s < splits; ++s) a = add_p(a, ws[s * n + i]);
  // DEFER's one scale row of the expert (gs == K)
  const auto* srow = static_cast<const typename Scale::Value*>(sc) +
                     static_cast<int64_t>(e) * N;
  out[i] = finish<Scale, DEFER>(a, srow, row_factor(sa, alpha, row, e), col);
}

// The operands of one launch (see w4a8_ring_launch)
struct RingArgs {
  const int8_t* x;
  const float* sa;
  const float* alpha;
  const uint8_t* w;
  const void* s;
  float* out;
  void* ws;
  const int* counts;
  int E, C, N, K, gs, splits;
};

template <int BM, bool W4, bool VEC, class Scale, bool DEFER, bool GROUPED>
cudaError_t ring_launch(const RingArgs& a, cudaStream_t st) {
  constexpr int bytes = Smem<BM, W4>::bytes;
  static bool attr[64] = {};
  auto* kernel = w4a8_ring_kernel<BM, W4, VEC, Scale, DEFER, GROUPED>;
  cudaError_t err = allow_smem(kernel, bytes, attr);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + BN - 1) / BN, (a.C + BM - 1) / BM, a.E * a.splits);
  kernel<<<grid, kThreads, bytes, st>>>(a.x, a.sa, a.alpha, a.w, a.s, a.out,
                                        a.ws,
                                        a.counts, a.E, a.C, a.N, a.K, a.gs,
                                        a.splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  const int64_t n = static_cast<int64_t>(a.E) * a.C * a.N;
  w4a8_splitk_reduce<Scale, DEFER, GROUPED>
      <<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
          static_cast<const Part<Scale, DEFER>*>(a.ws), a.s, a.sa, a.alpha,
          a.out,
          a.counts, a.C, a.N, n, a.splits);
  return cudaGetLastError();
}

template <class Scale, bool DEFER, bool G, int BM, bool W4>
cudaError_t ring_launch_vec(bool vec, const RingArgs& a, cudaStream_t st) {
  return vec ? ring_launch<BM, W4, true, Scale, DEFER, G>(a, st)
             : ring_launch<BM, W4, false, Scale, DEFER, G>(a, st);
}

template <class Scale, bool DEFER, bool G>
cudaError_t ring_launch_tile(int bm, int w_bits, bool vec, const RingArgs& a,
                             cudaStream_t st) {
  if (bm == 16) {
    return w_bits == 4
               ? ring_launch_vec<Scale, DEFER, G, 16, true>(vec, a, st)
               : ring_launch_vec<Scale, DEFER, G, 16, false>(vec, a, st);
  }
  return w_bits == 4 ? ring_launch_vec<Scale, DEFER, G, 64, true>(vec, a, st)
                     : ring_launch_vec<Scale, DEFER, G, 64, false>(vec, a, st);
}

// The body of the W4A8 C entry points, dense and grouped. xq (E*C, K) int8
// codes; sa (E*C,) f32, their per-row scales; alpha (E,) f32, the experts'
// amplifiers (Integer Scale; the epilogue's factor is sa / alpha[e]) or null
// (float scale: the factor is sa); counts (E,) int32 or null (every row
// routed); w (E, K/2, N) packed int4 (w_bits = 4) or (E, K, N) int8
// (w_bits = 8); s (E, K/gs, N) of Scale::Value; out
// (E*C, N) f32; ws (splits, E*C, N) of 4-byte elements when splits > 1
// (else unused). All contiguous and 16-byte aligned. K % 128 == 0,
// K % gs == 0, gs % 32 == 0, gs <= 2^16, 1 <= splits <= K / 128,
// E * splits <= 65535, E * C < 2^31; bm is 16 or 64. gs == K is one group
// over all of K (coarse). The dense GEMMs pass E = 1, C = M, no counts and
// GROUPED = false. Returns cudaGetLastError() after the launches.
template <class Scale, bool GROUPED>
int w4a8_ring_launch(const void* xq, const void* sa, const void* alpha,
                     const void* counts, const void* w, const void* s,
                     void* out, void* ws, int E, int C, int N, int K, int gs,
                     int w_bits, int bm, int splits, void* stream) {
  if ((w_bits != 4 && w_bits != 8) || K % KU != 0 || gs <= 0 ||
      gs % 32 != 0 || gs > MAX_GS || K % gs != 0 || splits < 1 ||
      splits > K / KU || E < 1 || (!GROUPED && (E != 1 || counts != nullptr)) ||
      static_cast<int64_t>(E) * splits > 65535 ||
      static_cast<int64_t>(E) * C > INT32_MAX ||
      (splits > 1 && ws == nullptr) || (bm != 16 && bm != 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (C <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RingArgs a{static_cast<const int8_t*>(xq),
                   static_cast<const float*>(sa),
                   static_cast<const float*>(alpha),
                   static_cast<const uint8_t*>(w),
                   s,
                   static_cast<float*>(out),
                   ws,
                   static_cast<const int*>(counts),
                   E, C, N, K, gs, splits};
  const bool vec = N % 16 == 0;
  // one group over all of K: for float scale the step waits for the int32
  // sums (bit-exact); the integer step is exact in any split
  if constexpr (!std::is_same<typename Scale::Acc, int>::value) {
    if (gs == K) {
      return static_cast<int>(
          ring_launch_tile<Scale, true, GROUPED>(bm, w_bits, vec, a, st));
    }
  }
  return static_cast<int>(
      ring_launch_tile<Scale, false, GROUPED>(bm, w_bits, vec, a, st));
}

}  // namespace
