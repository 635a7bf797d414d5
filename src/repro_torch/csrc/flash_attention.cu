// Flash-attention forward, causal (with an optional sliding window) or not,
// with GQA. Non-causal launches (cross attention over a memory, Sq != Sk,
// Sq = 1 in decode) visit every key tile; the last one is masked by
// k_pos < Sk where Sk is no multiple of the tile.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_tpu, the
//   Pallas TPU kernel (body _kernel).
// What bounds it on the H100: at the serving prefill (B = 1, Sq = Sk = 128,
//   32 heads of 128) the q/k/v/o bytes (4 MB, 1.25 us at 3.35 TB/s) and the
//   score/value FLOPs (0.13 GFLOP) are both small, so the time is set by
//   latency: how many blocks run at once and how fast each walks its key
//   tiles. It never writes the (Sq, Sk) score matrix to device memory.
// What the design does about it (second design, bf16): an FA2-style
//   forward on the tensor cores. One block of 2 warps per (query tile of
//   32 rows, batch * query head): 128 blocks at the serving prefill (the
//   first design's 64-row tiles gave 64). Q, K and V stay bf16 in shared
//   memory and arrive by 16-byte cp.async, K and V double-buffered, so the
//   next key tile loads while this one is computed. Each warp owns 16
//   query rows: S = Q K^T on mma.sync m16n8k16 (bf16 in, f32 accumulate;
//   Q fragments loaded once with ldmatrix and kept in registers, K's with
//   ldmatrix), the softmax scale applied to the f32 scores, the online
//   softmax on the accumulator fragments with quad shuffles for the row
//   max and sum, and P packed to bf16 registers as the A operand of P V
//   (V through ldmatrix.trans); the output accumulator stays in registers.
//   P goes in as two bf16 parts (hi and the rest, two MMAs), since P in
//   bf16 alone moved outputs of magnitude 2 to 4 by a bf16 ulp (0.0156),
//   near the 2e-2 bound, and one of magnitude 4 to 8 would cross it. Query
//   tiles run latest first, as the causal ones do the most work.
//   At head_dim 256 (RecurrentGemma's local attention) the Q fragments
//   would take 64 registers a thread beside the 128 of the output
//   accumulator: there they are reloaded from shared memory by ldmatrix
//   for each key tile instead of kept in registers (Q stays in shared
//   memory for the whole block anyway; 152,064 B of it at D = 256).
// f32 inputs keep the first design: scalar f32 FMAs from shared memory,
//   one block per (batch * query head, 64-row query tile) (213,504 B of
//   shared memory at D = 256).
// Both keep the TPU kernel's semantics: masked scores are NEG_INF = -1e30
//   (not -inf), padded keys are masked by k_pos < sk, query head r reads kv
//   head r / G, key tiles wholly past the causal diagonal or before the
//   window are skipped (the reference's masked blocks contribute exactly
//   zero there), and the epilogue floors the denominator at 1e-30. There is
//   no q offset: prefill starts at position 0.
// Training: given an lse pointer, both write each row's log-sum-exp
//   (natural log, f32, (B, Hq, Sq)) beside the output, for the backward in
//   flash_attention_bwd.cu; given none, they write only the output, as the
//   serving paths do.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_bf16.cuh"

namespace {

constexpr int BQ = 64, BK = 64, kThreads = 128;
constexpr int RPW = BQ / (kThreads / 32);  // query rows per warp: 16
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * BK);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv,
                 float scale, int causal, int window) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // BQ x (D+1), pre-scaled
  float* Ks = Qs + BQ * (D + 1);    // BK x (D+1)
  float* Vs = Ks + BK * (D + 1);    // BK x D
  float* Ps = Vs + BK * D;          // BQ x BK

  const int bh = blockIdx.x, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rbase = warp * RPW;
  // element (b, s, h, d) of a (B, S, H, D) tensor
  const int64_t qs = (int64_t)Hq * D, ks = (int64_t)Hkv * D;
  const T* qb = q + ((int64_t)b * Sq * Hq + h) * D;
  const T* kb = k + ((int64_t)b * Sk * Hkv + hk) * D;
  const T* vb = v + ((int64_t)b * Sk * Hkv + hk) * D;
  T* ob = o + ((int64_t)b * Sq * Hq + h) * D;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    Qs[r * (D + 1) + d] = q0 + r < Sq ? to_f32(qb[(q0 + r) * qs + d]) * scale : 0.f;
  }

  float m[RPW], l[RPW], acc[RPW][D / 32];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = NEG_INF;
    l[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 32; ++j) acc[rr][j] = 0.f;
  }

  const int q_last = min(q0 + BQ, Sq) - 1;
  int kt_end = (Sk + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, q_last / BK + 1);
  const int kt_begin = window >= 0 ? max(0, q0 - window + 1) / BK : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const bool in = k0 + r < Sk;
      Ks[r * (D + 1) + d] = in ? to_f32(kb[(k0 + r) * ks + d]) : 0.f;
      Vs[r * D + d] = in ? to_f32(vb[(k0 + r) * ks + d]) : 0.f;
    }
    __syncthreads();

    // scores for this warp's 16 rows against keys lane and lane + 32
    float s[RPW][2];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) s[rr][0] = s[rr][1] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float k0v = Ks[lane * (D + 1) + d];
      const float k1v = Ks[(lane + 32) * (D + 1) + d];
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const float qv = Qs[(rbase + rr) * (D + 1) + d];
        s[rr][0] = fmaf(qv, k0v, s[rr][0]);
        s[rr][1] = fmaf(qv, k1v, s[rr][1]);
      }
    }

    // mask, then the online-softmax update per row
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int qp = q0 + rbase + rr;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kp = k0 + lane + 32 * c;
        bool ok = kp < Sk;
        if (causal) ok = ok && kp <= qp;
        if (window >= 0) ok = ok && kp > qp - window;
        if (!ok) s[rr][c] = NEG_INF;
      }
      float mx = fmaxf(s[rr][0], s[rr][1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[rr], mx);
      const float corr = expf(m[rr] - m_new);
      const float p0 = expf(s[rr][0] - m_new);
      const float p1 = expf(s[rr][1] - m_new);
      float ps = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      }
      l[rr] = l[rr] * corr + ps;
      m[rr] = m_new;
#pragma unroll
      for (int j = 0; j < D / 32; ++j) acc[rr][j] *= corr;
      Ps[(rbase + rr) * BK + lane] = p0;
      Ps[(rbase + rr) * BK + lane + 32] = p1;
    }
    __syncwarp();

    // acc += P V over this warp's rows; lane owns dims lane + 32 j
    for (int j = 0; j < BK; ++j) {
      float vv[D / 32];
#pragma unroll
      for (int jj = 0; jj < D / 32; ++jj) vv[jj] = Vs[j * D + lane + 32 * jj];
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const float p = Ps[(rbase + rr) * BK + j];
#pragma unroll
        for (int jj = 0; jj < D / 32; ++jj) acc[rr][jj] = fmaf(p, vv[jj], acc[rr][jj]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int qp = q0 + rbase + rr;
    if (qp < Sq) {
      const float den = fmaxf(l[rr], 1e-30f);
#pragma unroll
      for (int jj = 0; jj < D / 32; ++jj) {
        store(ob + qp * qs + lane + 32 * jj, acc[rr][jj] / den);
      }
      if (lse != nullptr && lane == 0) {  // natural log, scores pre-scaled
        lse[static_cast<int64_t>(bh) * Sq + qp] = m[rr] + logf(den);
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Sk, int Hq, int Hkv, float scale, int causal,
           int window, cudaStream_t st) {
  const size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * Hq, (Sq + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, Hq, Hkv,
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int TQ = 32, TK = 64, kTcThreads = 64;  // 2 warps x 16 query rows

template <int D>
struct TcSmem {
  static constexpr int stride = D + 8;  // bf16 row stride (ldmatrix banks)
  static constexpr int q = TQ * stride;
  static constexpr int kv = TK * stride;
  static constexpr int bytes = (q + 4 * kv) * 2;  // Q, K x 2, V x 2
};

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int Sq, int Sk, int Hq, int Hkv, float scale, int causal,
                int window) {
  using L = TcSmem<D>;
  constexpr int ST = L::stride;
  constexpr int CH = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) __nv_bfloat16 sm[];
  __nv_bfloat16* Qs = sm;
  __nv_bfloat16* Ks = Qs + L::q;       // two buffers of TK rows
  __nv_bfloat16* Vs = Ks + 2 * L::kv;  // two buffers of TK rows

  const int q0 = (gridDim.x - 1 - blockIdx.x) * TQ;  // latest tile first
  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // element (b, s, h, d) of a (B, S, H, D) tensor
  const int64_t qs = static_cast<int64_t>(Hq) * D;
  const int64_t ks = static_cast<int64_t>(Hkv) * D;
  const __nv_bfloat16* qb = q + (static_cast<int64_t>(b) * Sq * Hq + h) * D;
  const __nv_bfloat16* kb = k + (static_cast<int64_t>(b) * Sk * Hkv + hk) * D;
  const __nv_bfloat16* vb = v + (static_cast<int64_t>(b) * Sk * Hkv + hk) * D;
  __nv_bfloat16* ob = o + (static_cast<int64_t>(b) * Sq * Hq + h) * D;

  const int q_last = min(q0 + TQ, Sq) - 1;
  int kt_end = (Sk + TK - 1) / TK;
  if (causal) kt_end = min(kt_end, q_last / TK + 1);
  const int kt_begin = window >= 0 ? max(0, q0 - window + 1) / TK : 0;

  for (int i = tid; i < TQ * CH; i += kTcThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool in = q0 + r < Sq;
    cp16(Qs + r * ST + c, qb + (in ? (q0 + r) * qs : 0) + c, in);
  }
  auto load_kv = [&](int buf, int kt) {
    const int k0 = kt * TK;
    for (int i = tid; i < TK * CH; i += kTcThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool in = k0 + r < Sk;
      const int64_t off = (in ? (k0 + r) * ks : 0) + c;
      cp16(Ks + buf * L::kv + r * ST + c, kb + off, in);
      cp16(Vs + buf * L::kv + r * ST + c, vb + off, in);
    }
  };
  if (kt_begin < kt_end) load_kv(0, kt_begin);
  cp_commit();

  const float sl2 = scale * LOG2E;  // scores in the log2 domain
  const int qr0 = q0 + warp * 16 + g, qr1 = qr0 + 8;  // this thread's rows
  // Q's fragments in registers up to D = 128; reloaded per key tile above
  constexpr bool kQInRegs = D <= 128;
  uint32_t qf[kQInRegs ? D / 16 : 1][4];
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1, k0 = kt * TK;
    __syncthreads();  // every warp is done with the other buffer
    if (kt + 1 < kt_end) load_kv(buf ^ 1, kt + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // this key tile (and Q) landed for every thread
    if (kQInRegs && kt == kt_begin) {
#pragma unroll
      for (int kk = 0; kk < (kQInRegs ? D / 16 : 0); ++kk) {
        ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * ST + kk * 16 +
                            (lane >> 4) * 8);
      }
    }
    const __nv_bfloat16* Kt = Ks + buf * L::kv;
    const __nv_bfloat16* Vt = Vs + buf * L::kv;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n8-fragments of keys
    float s[TK / 8][4];
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if constexpr (!kQInRegs) {
        ldmatrix_x4(qf[0], Qs + (warp * 16 + (lane & 15)) * ST + kk * 16 +
                           (lane >> 4) * 8);
      }
      const uint32_t(&qa)[4] = qf[kQInRegs ? kk : 0];
#pragma unroll
      for (int j2 = 0; j2 < TK / 16; ++j2) {
        uint32_t bk[4];  // keys 16 j2 .. +7 and +8 .. +15
        ldmatrix_x4(bk, Kt + (j2 * 16 + (lane >> 4) * 8 + (lane & 7)) * ST +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * j2], qa, bk[0], bk[1]);
        mma_bf16(s[2 * j2 + 1], qa, bk[2], bk[3]);
      }
    }

    // mask, scale, and the online-softmax update of rows qr0 and qr1
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + j * 8 + 2 * t + (i & 1);
        const int qp = i < 2 ? qr0 : qr1;
        bool ok = kp < Sk;
        if (causal) ok = ok && kp <= qp;
        if (window >= 0) ok = ok && kp > qp - window;
        s[j][i] = ok ? s[j][i] * sl2 : NEG_INF;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0);
      s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1);
      s[j][3] = exp2f(s[j][3] - mn1);
      ps0 += s[j][0] + s[j][1];
      ps1 += s[j][2] + s[j][3];
    }
    l0 = l0 * c0 + ps0;  // this thread's columns; summed over the quad last
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= c0;
      acc[j][1] *= c0;
      acc[j][2] *= c1;
      acc[j][3] *= c1;
    }

    // acc += P V, V through ldmatrix.trans. P from the score fragments as
    // two bf16 parts, hi = bf16(p) and lo = bf16(p - hi), each the A
    // operand of its own MMA: p - hi - lo is below 2^-16 p (see the header
    // for why P in bf16 alone is not enough)
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* p = &s[2 * kk + (i >> 1)][(i & 1) * 2];
        split_bf16(p[0], p[1], ph[i], pl[i]);
      }
#pragma unroll
      for (int d2 = 0; d2 < D / 16; ++d2) {
        uint32_t bv[4];  // dims 16 d2 .. +7 and +8 .. +15
        ldmatrix_x4_t(bv, Vt +
                          (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ST +
                          d2 * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * d2], ph, bv[0], bv[1]);
        mma_bf16(acc[2 * d2 + 1], ph, bv[2], bv[3]);
        mma_bf16(acc[2 * d2], pl, bv[0], bv[1]);
        mma_bf16(acc[2 * d2 + 1], pl, bv[2], bv[3]);
      }
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  if (lse != nullptr && t == 0) {  // natural log: m is in the log2 domain
    float* lb = lse + static_cast<int64_t>(bh) * Sq;
    if (qr0 < Sq) lb[qr0] = m0 * LN2 + logf(d0);
    if (qr1 < Sq) lb[qr1] = m1 * LN2 + logf(d1);
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (qr0 < Sq) {
      *reinterpret_cast<uint32_t*>(ob + qr0 * qs + c) =
          pack_bf16(acc[j][0] / d0, acc[j][1] / d0);
    }
    if (qr1 < Sq) {
      *reinterpret_cast<uint32_t*>(ob + qr1 * qs + c) =
          pack_bf16(acc[j][2] / d1, acc[j][3] / d1);
    }
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int Sq, int Sk, int Hq, int Hkv, float scale,
              int causal, int window, cudaStream_t st) {
  constexpr int bytes = TcSmem<D>::bytes;
  static bool attr[64] = {};  // the attribute is per kernel and device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !attr[dev]) {
    err = cudaFuncSetAttribute(flash_tc_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) attr[dev] = true;
  }
  const dim3 grid((Sq + TQ - 1) / TQ, B * Hq);
  flash_tc_kernel<D><<<grid, kTcThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, Sq, Sk, Hq, Hkv, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), o (B, Sq, Hq, D); all contiguous,
// one dtype: bf16 (is_bf16 = 1) or f32. D is 32, 64, 128 or 256;
// Hq % Hkv == 0.
// window < 0 means no window. lse: null, or f32 (B, Hq, Sq) that receives
// each row's log-sum-exp of its scaled, masked scores (natural log), which
// the backward (flash_attention_bwd.cu) reads; a null lse writes nothing
// more and changes no output bit. Returns cudaGetLastError() after the
// launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int is_bf16,
                                      int B, int Sq, int Sk, int Hq, int Hkv,
                                      int D, float scale, int causal,
                                      int window, void* stream, void* lse) {
  if (Hkv <= 0 || Hq % Hkv != 0 ||
      (D != 32 && D != 64 && D != 128 && D != 256)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (is_bf16) {
    switch (D) {
      case 256:
        return launch_tc<256>(q, k, v, o, l, B, Sq, Sk, Hq, Hkv, scale, causal, window, st);
      case 128:
        return launch_tc<128>(q, k, v, o, l, B, Sq, Sk, Hq, Hkv, scale, causal, window, st);
      case 64:
        return launch_tc<64>(q, k, v, o, l, B, Sq, Sk, Hq, Hkv, scale, causal, window, st);
      default:
        return launch_tc<32>(q, k, v, o, l, B, Sq, Sk, Hq, Hkv, scale, causal, window, st);
    }
  }
  switch (D) {
    case 256:
      return launch<float, 256>(q, k, v, o, l, B, Sq, Sk, Hq, Hkv, scale, causal, window, st);
    case 128:
      return launch<float, 128>(q, k, v, o, l, B, Sq, Sk, Hq, Hkv, scale, causal, window, st);
    case 64:
      return launch<float, 64>(q, k, v, o, l, B, Sq, Sk, Hq, Hkv, scale, causal, window, st);
    default:
      return launch<float, 32>(q, k, v, o, l, B, Sq, Sk, Hq, Hkv, scale, causal, window, st);
  }
}
