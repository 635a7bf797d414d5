// Flash-attention backward: dQ, dK and dV of flash_attention.cu's forward,
// causal (with an optional sliding window) or not, with GQA.
//
// Replaces: src/repro/models/attention.py::flash_attention, the jnp
//   attention that the reference's train step differentiates with
//   jax.value_and_grad (src/repro/training/train_step.py:43). Its TPU
//   kernel (flash_attention_tpu) has no backward; on the card the forward
//   is the hand-written kernel, so its gradient is one too.
// Semantics, the forward's exactly: q is scaled before the dot, masked
//   scores are NEG_INF (their probabilities exactly 0), the masks are
//   causal from position 0 with an optional window, or non-causal with
//   Sq != Sk; query head r reads kv head r / G; f32 math, gradients in the
//   inputs' dtype. P is recomputed from the forward's log-sum-exp:
//   P = exp(S - lse), dV = P^T dO, dP = dO V^T, dS = P (dP - delta) with
//   delta = rowsum(dO o O), dQ = scale dS K, dK = dS^T (scale Q).
// What bounds it on the H100: the five products over the unmasked
//   (query, key) pairs, 10 B Hq pairs D FLOPs (at llama3.2-3b's 4 x 1024
//   tokens, 24 heads of 128: 0.0645 TFLOP a layer, 0.065 ms at the bf16
//   tensor cores' 989 TFLOP/s); the bytes (q, k, v, o, dO and lse read
//   once, dq, dk, dv written once: 136 MB, 0.041 ms at 3.35 TB/s) less.
//   The first design did every product as scalar f32 FMAs from shared
//   memory: 87 times its bound.
// Design (bf16, the tensor cores): no atomics, so two calls give the same
//   bits. Three kernels, and a fourth where the heads are split:
//   1. delta: one warp per (b, row, head), f32 (B, Hq, Sq), each lane one
//      16-, 8-, 4- or 2-byte load of O and of dO.
//   2. dK, dV: one block of 4 warps per (key tile of TKV = 64, b, kv head,
//      split), earliest key tiles first (under a causal mask they see the
//      most query tiles). K and V stay in shared memory for the whole
//      block; the (Q, dO, lse, delta) tiles of TQS = 64 query rows, for
//      each query tile that can see the block's keys and each head of its
//      share of the group, are double-buffered by cp.async (16 bytes; 4
//      for lse and delta), so the next tile loads while this one is
//      computed. Each warp owns 16 key rows and walks the tile in chunks
//      of SUB = 32 queries: S^T = K Q^T and dP^T = V dO^T on mma.sync
//      m16n8k16 (bf16 in, f32 accumulate; K, V, Q and dO fragments by
//      ldmatrix, K's and V's reloaded per chunk: kept in registers they
//      would take 64 more a thread at D = 128), so that P^T and
//      dS^T = P^T o (dP^T - delta) come out in the accumulator layout and
//      are repacked in registers as the A operand of dV += P^T dO and
//      dK += dS^T Q (dO and Q by ldmatrix.trans): P and dS never pass
//      through shared memory. The dK and dV accumulators, 16 key rows x D
//      each, stay in registers (128 f32 a thread at D = 128).
//   3. dQ: one block of 4 warps per (query tile of TQD = 64, b, query
//      head), latest tiles first; K and V tiles of TKS = 32 rows
//      double-buffered by cp.async as in the forward's loop. Each warp
//      recomputes S = Q K^T and dP = dO V^T for its 16 rows, KSUB = 32
//      keys at a time (Q and dO fragments reloaded per chunk, which leaves
//      room for 3 blocks an SM at D = 128; kept in registers, they were
//      no faster at any head dim), and adds dQ += dS K (K by
//      ldmatrix.trans). Recomputing S and dP makes 7 products where 5
//      would do: the price of no atomics.
//   4. Filling the card: where the dK/dV grid (key tiles x B Hkv) is under
//      the card's SM count, the wrapper's launch plan splits the G query
//      heads of a group over `splits` blocks; each writes its f32 partial
//      dK and dV to the workspace (splits, B, Sk, Hkv, D) x 2, and a last
//      kernel adds the splits in a fixed order and rounds to bf16.
//   A warp skips the chunks the mask removes whole (past the causal
//   diagonal, before the window, padding): their P is exactly 0. On the
//   H100 a second path for chunks the mask keeps whole, with no
//   per-element test, made both kernels slower (more registers).
// Precision: bf16 products are exact in f32 and the sums are f32, but P
//   (into dV) and dS (into dK and dQ) are rounded when they become MMA
//   operands. Rounded once, they moved the f32 gradients of a CPU replay
//   of this design at llama-like shapes by a good part of half of
//   BWD_REL_TOLERANCE (2^-7 max |plain|), which is where a rounded result
//   can move by a second ulp; so each goes in as two bf16 parts, hi and
//   lo (split_bf16, one more MMA each), as the forward does for P: within
//   2^-16 of the f32 value. On the H100 a build without the second MMAs
//   was only a little faster.
// Resources (ptxas -v, sm_90a; chip_smoke.py prints them): at D = 128
//   dK/dV 255 registers, no spill, 105,472 B of shared memory: 2 blocks,
//   8 warps an SM; dQ 168 registers, no spill, 69,632 B: 3 blocks. At
//   D = 256 dK/dV 251 registers, no spill, 101,888 B: 2 blocks; dQ 255
//   registers, 16 B of spill stores, 135,168 B: 1 block. f32 at D = 256:
//   dK/dV 127 registers, dQ 64, no spill, 140,288 B.
// What holds it back, and stays for later: with mma.sync each warp loads
//   its own fragments from shared memory with ldmatrix for only 16 rows
//   of A, and the dK/dV block's 255 registers leave 8 warps an SM to hide
//   the latency (at the train step's shape the dK/dV pass takes 0.60 of
//   the time, dQ 0.36, delta 0.035: chip_smoke.py's [bwd] profile). wgmma
//   (64-row warpgroup tiles, B read by the tensor cores from swizzled
//   shared memory, asynchronous) and TMA are the next design. At D = 256
//   and RecurrentGemma's train shape (1 x 4096 tokens, 16 query heads
//   over one KV head, window 2048) dK/dV takes 1.94 ms and dQ 1.10 of
//   3.06, 0.085 of its 0.261 ms bound (cuDNN's backward: 3.55 ms).
// D = 256 (RecurrentGemma's local attention: 16 query heads over one KV
//   head, a window of 2048). One warp's dK and dV accumulators for 16 keys
//   x 256 dims would be 256 f32 a thread, past the 255 registers D = 128
//   already takes. So the D split: two warps share 16 key rows (TKV_256 =
//   32 keys a block of 4 warps), each computes S^T and dP^T over all 256
//   dims and accumulates dK and dV for its half of D, 128 f32 a thread as
//   at D = 128. The price: S^T and dP^T twice, 9 products where 7 are
//   done at D <= 128. The other layout, one warp making two passes over
//   the D halves, recomputes the same products and stages Q and dO twice.
//   Shared memory, rows of 264 bf16: K and V for 32 keys and
//   double-buffered Q and dO tiles of TQS_256 = 32 query rows, 101,888 B,
//   2 blocks an SM (64-row query tiles would take 169,984 B: one block);
//   dQ keeps its layout (16 rows x 256 dims a warp, 128 f32 a thread),
//   135,168 B: one block of 4 warps an SM. Few dK/dV blocks (4096 keys of
//   one KV head make 128) bring in the head split below.
// f32 inputs keep the first design: scalar f32 FMAs from shared memory,
//   one block of 256 threads per (key tile, b, kv head) for dK / dV and
//   per (query tile, b, query head) for dQ; f32 tiles padded to D + 1:
//   tiles of 64 rows (165,888 B at D = 128), of 32 at D = 256 (140,288
//   B). TF32 would break f32's 1e-5 bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_bf16.cuh"

namespace {

// f32: the scalar kernels. One tile size BT for query and key tiles: 64
// rows, and 32 at D = 256 (four 64-row tiles of 257 f32 would take
// 263,168 B of shared memory); each of the 16 x 16 threads owns BT / 16
// rows and columns of a tile's scores
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int BT = 64, BT_256 = 32;

template <int D>
constexpr int f32_tile = D > 128 ? BT_256 : BT;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

template <int D>
constexpr size_t smem_bytes() {  // Q, dO, K, V; P, dS; lse, delta
  constexpr int T = f32_tile<D>;
  return sizeof(float) * (4 * T * (D + 1) + 2 * T * (T + 1) + 2 * T);
}

// delta[b, h, s] = sum_d dO[b, s, h, d] O[b, s, h, d], one warp a row
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int64_t rows, int Sq,
                       int Hq, int D) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* op = o + row * D;
  const T* dp = dout + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) {
    acc = fmaf(to_f32(op[d]), to_f32(dp[d]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) {
    const int h = static_cast<int>(row % Hq);
    const int64_t bs = row / Hq;
    const int s = static_cast<int>(bs % Sq);
    const int64_t b = bs / Sq;
    delta[(b * Hq + h) * Sq + s] = acc;
  }
}

// rows [r0, r0 + BT) of head h of a (B, S, H, D) tensor into a (BT, D + 1)
// f32 tile, times mul; zeros past S
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int r0, int S, int64_t stride,
                                          float mul) {
  for (int i = threadIdx.x; i < f32_tile<D> * D; i += kThreads) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] =
        r0 + r < S ? to_f32(src[(r0 + r) * stride + d]) * mul : 0.f;
  }
}

// S = Qs Ks^T and dP = dOs Vs^T for one (query tile, key tile), masked;
// P = exp(S - lse) (0 where masked) and dS = P (dP - delta) into Ps / dSs
template <int D>
__device__ __forceinline__ void score_tile(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* lse_s, const float* dl_s, float* Ps, float* dSs, int q0,
    int k0, int Sq, int Sk, int causal, int window, int tx, int ty) {
  constexpr int T = f32_tile<D>, RI = T / 16;
  float s[RI][RI], dp[RI][RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int j = 0; j < RI; ++j) s[i][j] = dp[i][j] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[RI], oa[RI], kb[RI], vb[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      qa[i] = Qs[(ty + 16 * i) * (D + 1) + d];
      oa[i] = dOs[(ty + 16 * i) * (D + 1) + d];
      kb[i] = Ks[(tx + 16 * i) * (D + 1) + d];
      vb[i] = Vs[(tx + 16 * i) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i, qp = q0 + r;
#pragma unroll
    for (int j = 0; j < RI; ++j) {
      const int c = tx + 16 * j, kp = k0 + c;
      bool ok = qp < Sq && kp < Sk;
      if (causal) ok = ok && kp <= qp;
      if (window >= 0) ok = ok && kp > qp - window;
      const float p = ok ? expf(s[i][j] - lse_s[r]) : 0.f;
      Ps[r * (T + 1) + c] = p;
      dSs[r * (T + 1) + c] = p * (dp[i][j] - dl_s[r]);
    }
  }
}

struct Smem {
  float *Qs, *dOs, *Ks, *Vs, *Ps, *dSs, *lse_s, *dl_s;
};

template <int D>
__device__ __forceinline__ Smem carve(float* smem) {
  constexpr int T = f32_tile<D>;
  Smem m;
  m.Qs = smem;
  m.dOs = m.Qs + T * (D + 1);
  m.Ks = m.dOs + T * (D + 1);
  m.Vs = m.Ks + T * (D + 1);
  m.Ps = m.Vs + T * (D + 1);
  m.dSs = m.Ps + T * (T + 1);
  m.lse_s = m.dSs + T * (T + 1);
  m.dl_s = m.lse_s + T;
  return m;
}

// Q (scaled), dO, lse and delta of query rows [q0, q0 + BT) of head h
template <typename T, int D>
__device__ __forceinline__ void load_query_side(
    const Smem& m, const T* __restrict__ q, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, int b,
    int h, int q0, int Sq, int Hq, float scale) {
  const int64_t qs = static_cast<int64_t>(Hq) * D;
  const int64_t off = (static_cast<int64_t>(b) * Sq * Hq + h) * D;
  load_tile<T, D>(m.Qs, q + off, q0, Sq, qs, scale);
  load_tile<T, D>(m.dOs, dout + off, q0, Sq, qs, 1.f);
  const int64_t row = (static_cast<int64_t>(b) * Hq + h) * Sq;
  for (int r = threadIdx.x; r < f32_tile<D>; r += kThreads) {
    const bool in = q0 + r < Sq;
    m.lse_s[r] = in ? lse[row + q0 + r] : 0.f;
    m.dl_s[r] = in ? delta[row + q0 + r] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv,
                      float scale, int causal, int window) {
  constexpr int BQ = f32_tile<D>, BK = BQ, RI = BQ / 16;
  extern __shared__ float smem[];
  const Smem m = carve<D>(smem);
  const int k0 = blockIdx.x * BK;  // earliest key tile first
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv, G = Hq / Hkv;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t ks = static_cast<int64_t>(Hkv) * D;
  const int64_t koff = (static_cast<int64_t>(b) * Sk * Hkv + hk) * D;
  load_tile<T, D>(m.Ks, k + koff, k0, Sk, ks, 1.f);
  load_tile<T, D>(m.Vs, v + koff, k0, Sk, ks, 1.f);

  // the query tiles that can see a key of [k0, k0 + BK)
  const int nq = (Sq + BQ - 1) / BQ;
  const int qt_begin = causal ? min(k0 / BQ, nq) : 0;
  int qt_end = nq;
  if (window >= 0) qt_end = min(nq, (k0 + BK - 1 + window - 1) / BQ + 1);

  constexpr int DJ = D / 16;
  float aK[RI][DJ], aV[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int j = 0; j < DJ; ++j) aK[i][j] = aV[i][j] = 0.f;
  }
  for (int h = hk * G; h < (hk + 1) * G; ++h) {
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // every thread is done with the last tile's P / dS
      load_query_side<T, D>(m, q, dout, lse, delta, b, h, q0, Sq, Hq, scale);
      __syncthreads();
      score_tile<D>(m.Qs, m.dOs, m.Ks, m.Vs, m.lse_s, m.dl_s, m.Ps, m.dSs,
                    q0, k0, Sq, Sk, causal, window, tx, ty);
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float p[RI], ds[RI], o[DJ], x[DJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          p[i] = m.Ps[r * (BK + 1) + ty + 16 * i];
          ds[i] = m.dSs[r * (BK + 1) + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          o[j] = m.dOs[r * (D + 1) + tx + 16 * j];
          x[j] = m.Qs[r * (D + 1) + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i) {
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            aV[i][j] = fmaf(p[i], o[j], aV[i][j]);
            aK[i][j] = fmaf(ds[i], x[j], aK[i][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp < Sk) {
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int64_t at = koff + kp * ks + tx + 16 * j;
        store(dk + at, aK[i][j]);
        store(dv + at, aV[i][j]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Sk, int Hq, int Hkv, float scale, int causal,
                    int window) {
  constexpr int BQ = f32_tile<D>, BK = BQ, RI = BQ / 16;
  extern __shared__ float smem[];
  const Smem m = carve<D>(smem);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // latest tile first
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq;
  const int hk = h / (Hq / Hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_query_side<T, D>(m, q, dout, lse, delta, b, h, q0, Sq, Hq, scale);

  // the forward's key tiles of this query tile
  const int q_last = min(q0 + BQ, Sq) - 1;
  int kt_end = (Sk + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, q_last / BK + 1);
  const int kt_begin = window >= 0 ? max(0, q0 - window + 1) / BK : 0;
  const int64_t ks = static_cast<int64_t>(Hkv) * D;
  const int64_t koff = (static_cast<int64_t>(b) * Sk * Hkv + hk) * D;

  constexpr int DJ = D / 16;
  float aQ[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int j = 0; j < DJ; ++j) aQ[i][j] = 0.f;
  }
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every thread is done with the last K tile and dS
    load_tile<T, D>(m.Ks, k + koff, k0, Sk, ks, 1.f);
    load_tile<T, D>(m.Vs, v + koff, k0, Sk, ks, 1.f);
    __syncthreads();
    score_tile<D>(m.Qs, m.dOs, m.Ks, m.Vs, m.lse_s, m.dl_s, m.Ps, m.dSs, q0,
                  k0, Sq, Sk, causal, window, tx, ty);
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float ds[RI], kv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) ds[i] = m.dSs[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = m.Ks[c * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
#pragma unroll
        for (int j = 0; j < DJ; ++j) aQ[i][j] = fmaf(ds[i], kv[j], aQ[i][j]);
      }
    }
  }
  const int64_t qs = static_cast<int64_t>(Hq) * D;
  const int64_t qoff = (static_cast<int64_t>(b) * Sq * Hq + h) * D;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp < Sq) {
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        store(dq + qoff + qp * qs + tx + 16 * j, aQ[i][j] * scale);
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, float* delta, void* dq,
           void* dk, void* dv, int B, int Sq, int Sk, int Hq, int Hkv,
           float scale, int causal, int window, cudaStream_t st) {
  constexpr int BQ = f32_tile<D>, BK = BQ;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int64_t rows = static_cast<int64_t>(B) * Sq * Hq;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + kWarps - 1) / kWarps),
                              kThreads, 0, st>>>(
      static_cast<const T*>(o), dot, delta, rows, Sq, Hq, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int bytes = static_cast<int>(smem_bytes<D>());
  // the attribute is per kernel and device; set once, so that a launch
  // inside a CUDA graph capture makes no such call
  static bool attr[64] = {};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !attr[dev]) {
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) attr[dev] = true;
  }
  if (Sk > 0) {
    flash_bwd_dkdv_kernel<T, D>
        <<<dim3((Sk + BK - 1) / BK, B * Hkv), kThreads, bytes, st>>>(
            qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
            static_cast<T*>(dv), Sq, Sk, Hq, Hkv, scale, causal, window);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  flash_bwd_dq_kernel<T, D>
      <<<dim3((Sq + BQ - 1) / BQ, B * Hq), kThreads, bytes, st>>>(
          qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), Sq, Sk, Hq, Hkv,
          scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v,
             const void* o, const float* lse, const void* dout, float* delta,
             void* dq, void* dk, void* dv, int B, int Sq, int Sk, int Hq,
             int Hkv, float scale, int causal, int window, cudaStream_t st) {
  switch (D) {
    case 256:
      return launch<T, 256>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, Sq,
                            Sk, Hq, Hkv, scale, causal, window, st);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, Sq,
                            Sk, Hq, Hkv, scale, causal, window, st);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, Sq,
                           Sk, Hq, Hkv, scale, causal, window, st);
    default:
      return launch<T, 32>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, Sq,
                           Sk, Hq, Hkv, scale, causal, window, st);
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TKV = 64;  // key rows of a dK/dV block: 4 warps x 16
constexpr int TQS = 64;  // query rows the dK/dV block stages a step
constexpr int SUB = 32;  // query columns of a dK/dV warp's chunk
constexpr int TQD = 64;  // query rows of a dQ block: 4 warps x 16
constexpr int TKS = 32;   // key rows the dQ block stages a step
constexpr int KSUB = 32;  // keys of a dQ warp's chunk
// D = 256: two warps share 16 key rows, each accumulating dK and dV for
// half of D, so a dK/dV block holds 2 x 16 keys and stages 32 query rows
// a step (see the header)
constexpr int TKV_256 = 32, TQS_256 = 32;
constexpr int kTcThreads = 128;
static_assert(TKV == 16 * (kTcThreads / 32) && TQD == TKV, "16 rows a warp");
static_assert(TKV_256 == 16 * (kTcThreads / 32) / 2, "2 warps a 16-key row");
static_assert(TQS % SUB == 0 && TQS_256 % SUB == 0 && SUB % 16 == 0 &&
                  TKS % KSUB == 0 && KSUB % 16 == 0, "k16 steps");

// The bf16 layout of one head dim: the dK/dV block's key rows (tkv) and
// staged query rows (tqs), the dims a dK/dV warp accumulates (wd) and the
// warps that share its 16 key rows (wpk)
template <int D>
struct TcTiles {
  static constexpr bool split_d = D > 128;
  static constexpr int tkv = split_d ? TKV_256 : TKV;
  static constexpr int tqs = split_d ? TQS_256 : TQS;
  static constexpr int wd = split_d ? D / 2 : D;
  static constexpr int wpk = D / wd;
};

template <int D>
struct TcSmem {
  static constexpr int stride = D + 8;  // bf16 row stride (ldmatrix banks)
  static constexpr int tqs = TcTiles<D>::tqs;
  static constexpr int kv = TcTiles<D>::tkv * stride, qs = tqs * stride;
  static constexpr int qd = TQD * stride, ks = TKS * stride;
  // dK/dV: K, V; Q x 2, dO x 2; lse x 2, delta x 2 (f32)
  static constexpr int dkdv = (2 * kv + 4 * qs) * 2 + 4 * tqs * 4;
  // dQ: Q, dO; K x 2, V x 2
  static constexpr int dq = (2 * qd + 4 * ks) * 2;
};

// Lane offsets (elements) of the three ldmatrix.x4 patterns in a tile of
// row stride ST: the A operand (16 rows x k16), two B operands of n8 x k16
// read from n-major rows, and two of k16 x n8 read from k-major rows
// (.trans).
template <int ST>
__device__ __forceinline__ int a_lane(int lane) {
  return (lane & 15) * ST + (lane >> 4) * 8;
}
template <int ST>
__device__ __forceinline__ int b_lane(int lane) {
  return ((lane >> 4) * 8 + (lane & 7)) * ST + ((lane >> 3) & 1) * 8;
}
template <int ST>
__device__ __forceinline__ int t_lane(int lane) {
  return (((lane >> 3) & 1) * 8 + (lane & 7)) * ST + (lane >> 4) * 8;
}

// The A fragment (16 rows x k16) of columns [16 c, 16 c + 16) of an m16 x n
// accumulator acc[n / 8][4], as bf16 parts hi and lo (P and dS go into
// their MMAs as both: see the header)
__device__ __forceinline__ void a_frag(const float (*acc)[4], int c,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* p = &acc[2 * c + (i >> 1)][(i & 1) * 2];
    split_bf16(p[0], p[1], hi[i], lo[i]);
  }
}

__device__ __forceinline__ bool visible(int qp, int kp, int Sq, int Sk,
                                        int causal, int window) {
  bool ok = qp < Sq && kp < Sk;
  if (causal) ok = ok && kp <= qp;
  if (window >= 0) ok = ok && kp > qp - window;
  return ok;
}

// rows [r0, r0 + R) of a (B, S, H, D) tensor's head at base (row stride
// rs) into a bf16 tile of row stride D + 8; zeros past S
template <int D, int R>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* base,
                                           int r0, int S, int64_t rs) {
  constexpr int CH = D / 8, ST = D + 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < R * CH; i += kTcThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool in = r0 + r < S;
    cp16(dst + r * ST + c, base + (in ? (r0 + r) * rs : 0) + c, in);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, float* __restrict__ ws, int B,
                  int Sq, int Sk, int Hq, int Hkv, float scale, int causal,
                  int window, int splits) {
  using L = TcSmem<D>;
  using W = TcTiles<D>;
  constexpr int TKV = W::tkv, TQS = W::tqs;  // this head dim's tiles
  // S^T and dP^T over all of D; dK and dV over this warp's wd dims
  constexpr int ST = L::stride, DK = D / 16, DKW = W::wd / 16,
                DN = W::wd / 8;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_tc);
  bf16* Vs = Ks + L::kv;
  bf16* Qs = Vs + L::kv;      // two buffers
  bf16* Os = Qs + 2 * L::qs;  // dO, two buffers
  float* ls = reinterpret_cast<float*>(Os + 2 * L::qs);  // lse x 2
  float* dls = ls + 2 * TQS;                               // delta x 2

  const int k0 = blockIdx.x * TKV;  // earliest key tile first
  const int z = blockIdx.y % splits, bkh = blockIdx.y / splits;
  const int b = bkh / Hkv, hk = bkh % Hkv;
  const int G = Hq / Hkv, Gs = G / splits, h0 = hk * G + z * Gs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // element (b, s, h, d) of a (B, S, H, D) tensor
  const int64_t qs = static_cast<int64_t>(Hq) * D;
  const int64_t ks = static_cast<int64_t>(Hkv) * D;
  const int64_t koff = (static_cast<int64_t>(b) * Sk * Hkv + hk) * D;

  stage_rows<D, TKV>(Ks, k + koff, k0, Sk, ks);
  stage_rows<D, TKV>(Vs, v + koff, k0, Sk, ks);
  cp_commit();

  // the query tiles that can see a key of [k0, k0 + TKV), for each of the
  // Gs heads of this block: step it is head h0 + it / nqt, tile it % nqt
  const int nq = (Sq + TQS - 1) / TQS;
  const int qt_begin = causal ? min(k0 / TQS, nq) : 0;
  int qt_end = nq;
  if (window >= 0) qt_end = min(nq, (k0 + TKV - 2 + window) / TQS + 1);
  const int nqt = max(qt_end - qt_begin, 0), steps = Gs * nqt;
  auto stage_step = [&](int buf, int it) {
    const int h = h0 + it / nqt, q0 = (qt_begin + it % nqt) * TQS;
    const int64_t qoff = (static_cast<int64_t>(b) * Sq * Hq + h) * D;
    stage_rows<D, TQS>(Qs + buf * L::qs, q + qoff, q0, Sq, qs);
    stage_rows<D, TQS>(Os + buf * L::qs, dout + qoff, q0, Sq, qs);
    const int64_t row = (static_cast<int64_t>(b) * Hq + h) * Sq;
    for (int r = tid; r < TQS; r += kTcThreads) {
      const bool in = q0 + r < Sq;
      const int64_t at = row + (in ? q0 + r : 0);
      cp4(ls + buf * TQS + r, lse + at, in);
      cp4(dls + buf * TQS + r, delta + at, in);
    }
  };
  if (steps > 0) stage_step(0, 0);
  cp_commit();

  const float sl2 = scale * LOG2E;  // scores in the log2 domain
  const int kr = warp / W::wpk;     // this warp's 16 keys
  const int kw0 = k0 + kr * 16;
  const int dw0 = (warp % W::wpk) * W::wd;  // and its dims of dK and dV
  const bf16* Kw = Ks + kr * 16 * ST + a_lane<ST>(lane);
  const bf16* Vw = Vs + kr * 16 * ST + a_lane<ST>(lane);
  const int bl = b_lane<ST>(lane), tl = t_lane<ST>(lane);
  float aK[DN][4], aV[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) aK[j][i] = aV[j][i] = 0.f;
  }

  for (int it = 0; it < steps; ++it) {
    const int buf = it & 1, q0 = (qt_begin + it % nqt) * TQS;
    __syncthreads();  // every warp is done with the other buffer
    if (it + 1 < steps) stage_step(buf ^ 1, it + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // this step's tiles (and K, V) landed
    const bf16* Qt = Qs + buf * L::qs;
    const bf16* Ot = Os + buf * L::qs;
    const float* lt = ls + buf * TQS;
    const float* dt = dls + buf * TQS;
#pragma unroll 1
    for (int c0 = 0; c0 < TQS; c0 += SUB) {
      const int qc = q0 + c0;
      // a chunk the mask removes whole for this warp's keys
      if (qc >= Sq || kw0 >= Sk) continue;
      if (causal && qc + SUB - 1 < kw0) continue;
      if (window >= 0 && qc >= kw0 + 15 + window) continue;

      // S^T = K Q^T and dP^T = V dO^T: 16 keys x SUB queries
      float st[SUB / 8][4], dpt[SUB / 8][4];
#pragma unroll
      for (int j = 0; j < SUB / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) st[j][i] = dpt[j][i] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        uint32_t ka[4], va[4];  // K and V fragments, reloaded per chunk
        ldmatrix_x4(ka, Kw + kk * 16);
        ldmatrix_x4(va, Vw + kk * 16);
#pragma unroll
        for (int j2 = 0; j2 < SUB / 16; ++j2) {
          uint32_t bf[4];  // queries c0 + 16 j2 .. +7 and +8 .. +15
          ldmatrix_x4(bf, Qt + (c0 + j2 * 16) * ST + bl + kk * 16);
          mma_bf16(st[2 * j2], ka, bf[0], bf[1]);
          mma_bf16(st[2 * j2 + 1], ka, bf[2], bf[3]);
          ldmatrix_x4(bf, Ot + (c0 + j2 * 16) * ST + bl + kk * 16);
          mma_bf16(dpt[2 * j2], va, bf[0], bf[1]);
          mma_bf16(dpt[2 * j2 + 1], va, bf[2], bf[3]);
        }
      }

      // P^T = exp(S^T - lse) where visible, dS^T = P^T (dP^T - delta):
      // element i of fragment j is key kw0 + g + 8 (i >> 1), query
      // qc + 8 j + 2 t + (i & 1)
#pragma unroll
      for (int j = 0; j < SUB / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ql = c0 + 8 * j + 2 * t + e;
          const float l2 = lt[ql] * LOG2E, dl = dt[ql];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 2 * r + e;
            const float p =
                visible(q0 + ql, kw0 + g + 8 * r, Sq, Sk, causal, window)
                    ? exp2f(fmaf(st[j][i], sl2, -l2))
                    : 0.f;
            st[j][i] = p;
            dpt[j][i] = p * (dpt[j][i] - dl);
          }
        }
      }

      // dV += P^T dO and dK += dS^T Q, k16 steps over the chunk's queries
#pragma unroll
      for (int c = 0; c < SUB / 16; ++c) {
        uint32_t ph[4], pl[4], sh[4], sl[4];
        a_frag(st, c, ph, pl);
        a_frag(dpt, c, sh, sl);
        const int row = (c0 + 16 * c) * ST + tl + dw0;
#pragma unroll
        for (int d2 = 0; d2 < DKW; ++d2) {
          uint32_t bt[4];  // dims dw0 + 16 d2 .. +7 and +8 .. +15
          ldmatrix_x4_t(bt, Ot + row + d2 * 16);
          mma_bf16(aV[2 * d2], ph, bt[0], bt[1]);
          mma_bf16(aV[2 * d2 + 1], ph, bt[2], bt[3]);
          mma_bf16(aV[2 * d2], pl, bt[0], bt[1]);
          mma_bf16(aV[2 * d2 + 1], pl, bt[2], bt[3]);
          ldmatrix_x4_t(bt, Qt + row + d2 * 16);
          mma_bf16(aK[2 * d2], sh, bt[0], bt[1]);
          mma_bf16(aK[2 * d2 + 1], sh, bt[2], bt[3]);
          mma_bf16(aK[2 * d2], sl, bt[0], bt[1]);
          mma_bf16(aK[2 * d2 + 1], sl, bt[2], bt[3]);
        }
      }
    }
  }
  cp_wait<0>();

  // rows kw0 + g and kw0 + g + 8, dims dw0 + 8 j + 2 t and + 1: bf16 into
  // dk / dv, or this split's f32 partial into the workspace
  const int64_t slab = static_cast<int64_t>(B) * Sk * Hkv * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = kw0 + g + 8 * r;
    if (kp >= Sk) continue;
    const int64_t at0 = koff + kp * ks + dw0 + 2 * t;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      const int64_t at = at0 + 8 * j;
      const float k0v = aK[j][2 * r] * scale, k1v = aK[j][2 * r + 1] * scale;
      const float v0v = aV[j][2 * r], v1v = aV[j][2 * r + 1];
      if (splits == 1) {
        *reinterpret_cast<uint32_t*>(dk + at) = pack_bf16(k0v, k1v);
        *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16(v0v, v1v);
      } else {
        *reinterpret_cast<float2*>(ws + z * slab + at) = make_float2(k0v, k1v);
        *reinterpret_cast<float2*>(ws + (splits + z) * slab + at) =
            make_float2(v0v, v1v);
      }
    }
  }
}

// delta[b, h, s] = sum_d dO[b, s, h, d] O[b, s, h, d] for bf16, one warp a
// row: lane l sums dims [E l, E l + E) in order (E = D / 32, one load of
// 2E bytes each: 16 at D = 256), then the warp's butterfly
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_bf16(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                     float* __restrict__ delta, int64_t rows, int Sq, int Hq) {
  constexpr int E = D / 32;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bf16* op = o + row * D + lane * E;
  const bf16* dp = dout + row * D + lane * E;
  uint32_t a[E > 1 ? E / 2 : 1], b[E > 1 ? E / 2 : 1];  // bf16 pairs
  if constexpr (E == 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(op);
    const uint4 y = *reinterpret_cast<const uint4*>(dp);
    a[0] = x.x, a[1] = x.y, a[2] = x.z, a[3] = x.w;
    b[0] = y.x, b[1] = y.y, b[2] = y.z, b[3] = y.w;
  } else if constexpr (E == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(op);
    const uint2 y = *reinterpret_cast<const uint2*>(dp);
    a[0] = x.x, a[1] = x.y, b[0] = y.x, b[1] = y.y;
  } else if constexpr (E == 2) {
    a[0] = *reinterpret_cast<const uint32_t*>(op);
    b[0] = *reinterpret_cast<const uint32_t*>(dp);
  } else {  // one element, as the low half of a pair
    a[0] = *reinterpret_cast<const unsigned short*>(op);
    b[0] = *reinterpret_cast<const unsigned short*>(dp);
  }
  float acc = 0.f;
#pragma unroll
  for (int w = 0; w < (E > 1 ? E / 2 : 1); ++w) {
    acc = fmaf(__uint_as_float(a[w] << 16), __uint_as_float(b[w] << 16), acc);
    if constexpr (E > 1) {
      acc = fmaf(__uint_as_float(a[w] & 0xffff0000u),
                 __uint_as_float(b[w] & 0xffff0000u), acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) {
    const int h = static_cast<int>(row % Hq);
    const int64_t bs = row / Hq;
    const int s = static_cast<int>(bs % Sq);
    const int64_t b = bs / Sq;
    delta[(b * Hq + h) * Sq + s] = acc;
  }
}

// dk = bf16(sum of the splits' dK partials), dv likewise, splits in order
__global__ void __launch_bounds__(256)
flash_bwd_sum_splits(const float* __restrict__ ws, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int64_t slab, int splits) {
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < slab; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float sk = ws[e], sv = ws[splits * slab + e];
    for (int z = 1; z < splits; ++z) {
      sk += ws[z * slab + e];
      sv += ws[(splits + z) * slab + e];
    }
    dk[e] = __float2bfloat16_rn(sk);
    dv[e] = __float2bfloat16_rn(sv);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq,
                int Sq, int Sk, int Hq, int Hkv, float scale, int causal,
                int window) {
  using L = TcSmem<D>;
  constexpr int ST = L::stride, DK = D / 16, DN = D / 8;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* Os = Qs + L::qd;
  bf16* Ks = Os + L::qd;      // two buffers
  bf16* Vs = Ks + 2 * L::ks;  // two buffers

  const int q0 = (gridDim.x - 1 - blockIdx.x) * TQD;  // latest tile first
  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t qs = static_cast<int64_t>(Hq) * D;
  const int64_t ks = static_cast<int64_t>(Hkv) * D;
  const int64_t qoff = (static_cast<int64_t>(b) * Sq * Hq + h) * D;
  const int64_t koff = (static_cast<int64_t>(b) * Sk * Hkv + hk) * D;

  // the forward's key tiles of this query tile
  const int q_last = min(q0 + TQD, Sq) - 1;
  int kt_end = (Sk + TKS - 1) / TKS;
  if (causal) kt_end = min(kt_end, q_last / TKS + 1);
  const int kt_begin = window >= 0 ? max(0, q0 - window + 1) / TKS : 0;

  stage_rows<D, TQD>(Qs, q + qoff, q0, Sq, qs);
  stage_rows<D, TQD>(Os, dout + qoff, q0, Sq, qs);
  auto stage_kv = [&](int buf, int kt) {
    stage_rows<D, TKS>(Ks + buf * L::ks, k + koff, kt * TKS, Sk, ks);
    stage_rows<D, TKS>(Vs + buf * L::ks, v + koff, kt * TKS, Sk, ks);
  };
  if (kt_begin < kt_end) stage_kv(0, kt_begin);
  cp_commit();

  const float sl2 = scale * LOG2E;
  const int qw0 = q0 + warp * 16;  // this warp's 16 rows
  const int qr0 = qw0 + g, qr1 = qr0 + 8;
  const int64_t row = static_cast<int64_t>(bh) * Sq;
  const float l2_0 = qr0 < Sq ? lse[row + qr0] * LOG2E : 0.f;
  const float l2_1 = qr1 < Sq ? lse[row + qr1] * LOG2E : 0.f;
  const float dl0 = qr0 < Sq ? delta[row + qr0] : 0.f;
  const float dl1 = qr1 < Sq ? delta[row + qr1] : 0.f;
  const int bl = b_lane<ST>(lane), tl = t_lane<ST>(lane);
  const int qa = warp * 16 * ST + a_lane<ST>(lane);
  float aQ[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) aQ[j][i] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1, k0 = kt * TKS;
    __syncthreads();  // every warp is done with the other buffer
    if (kt + 1 < kt_end) stage_kv(buf ^ 1, kt + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // this key tile (and Q, dO) landed
    const bf16* Kt = Ks + buf * L::ks;
    const bf16* Vt = Vs + buf * L::ks;
#pragma unroll 1
    for (int c0 = 0; c0 < TKS; c0 += KSUB) {
      const int kc = k0 + c0;
      // a chunk the mask removes whole for this warp's rows
      if (kc >= Sk || qw0 >= Sq) continue;
      if (causal && kc > qw0 + 15) continue;
      if (window >= 0 && qw0 >= kc + KSUB - 1 + window) continue;

      // S = Q K^T and dP = dO V^T: 16 rows x KSUB keys
      float s[KSUB / 8][4], dp[KSUB / 8][4];
#pragma unroll
      for (int j = 0; j < KSUB / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        uint32_t qa4[4], oa4[4];  // Q and dO fragments, reloaded per chunk
        ldmatrix_x4(qa4, Qs + qa + kk * 16);
        ldmatrix_x4(oa4, Os + qa + kk * 16);
#pragma unroll
        for (int j2 = 0; j2 < KSUB / 16; ++j2) {
          uint32_t bf[4];  // keys c0 + 16 j2 .. +7 and +8 .. +15
          ldmatrix_x4(bf, Kt + (c0 + 16 * j2) * ST + bl + kk * 16);
          mma_bf16(s[2 * j2], qa4, bf[0], bf[1]);
          mma_bf16(s[2 * j2 + 1], qa4, bf[2], bf[3]);
          ldmatrix_x4(bf, Vt + (c0 + 16 * j2) * ST + bl + kk * 16);
          mma_bf16(dp[2 * j2], oa4, bf[0], bf[1]);
          mma_bf16(dp[2 * j2 + 1], oa4, bf[2], bf[3]);
        }
      }
      // element i of fragment j: row qr0 (i < 2) or qr1, key
      // kc + 8 j + 2 t + (i & 1); s becomes dS
#pragma unroll
      for (int j = 0; j < KSUB / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qp = i < 2 ? qr0 : qr1, kp = kc + 8 * j + 2 * t + (i & 1);
          const float p = visible(qp, kp, Sq, Sk, causal, window)
                              ? exp2f(fmaf(s[j][i], sl2, i < 2 ? -l2_0 : -l2_1))
                              : 0.f;
          s[j][i] = p * (dp[j][i] - (i < 2 ? dl0 : dl1));
        }
      }
      // dQ += dS K, K through ldmatrix.trans
#pragma unroll
      for (int c = 0; c < KSUB / 16; ++c) {
        uint32_t sh[4], sl[4];
        a_frag(s, c, sh, sl);
#pragma unroll
        for (int d2 = 0; d2 < DK; ++d2) {
          uint32_t bt[4];  // dims 16 d2 .. +7 and +8 .. +15
          ldmatrix_x4_t(bt, Kt + (c0 + 16 * c) * ST + tl + d2 * 16);
          mma_bf16(aQ[2 * d2], sh, bt[0], bt[1]);
          mma_bf16(aQ[2 * d2 + 1], sh, bt[2], bt[3]);
          mma_bf16(aQ[2 * d2], sl, bt[0], bt[1]);
          mma_bf16(aQ[2 * d2 + 1], sl, bt[2], bt[3]);
        }
      }
    }
  }
  cp_wait<0>();

  bf16* ob = dq + qoff;
#pragma unroll
  for (int j = 0; j < DN; ++j) {
    const int c = j * 8 + 2 * t;
    if (qr0 < Sq) {
      *reinterpret_cast<uint32_t*>(ob + qr0 * qs + c) =
          pack_bf16(aQ[j][0] * scale, aQ[j][1] * scale);
    }
    if (qr1 < Sq) {
      *reinterpret_cast<uint32_t*>(ob + qr1 * qs + c) =
          pack_bf16(aQ[j][2] * scale, aQ[j][3] * scale);
    }
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* o,
              const float* lse, const void* dout, float* delta, void* dq,
              void* dk, void* dv, float* ws, int B, int Sq, int Sk, int Hq,
              int Hkv, float scale, int causal, int window, int splits,
              cudaStream_t st) {
  using L = TcSmem<D>;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  const int64_t rows = static_cast<int64_t>(B) * Sq * Hq;
  flash_bwd_delta_bf16<D>
      <<<static_cast<unsigned>((rows + kWarps - 1) / kWarps), kThreads, 0,
         st>>>(static_cast<const bf16*>(o), dot, delta, rows, Sq, Hq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the attribute is per kernel and device; set once, so that a launch
  // inside a CUDA graph capture makes no such call
  static bool attr_kv[64] = {}, attr_q[64] = {};
  err = allow_smem(flash_bwd_dkdv_tc<D>, L::dkdv, attr_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(flash_bwd_dq_tc<D>, L::dq, attr_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Sk > 0) {
    constexpr int tkv = TcTiles<D>::tkv;
    flash_bwd_dkdv_tc<D>
        <<<dim3((Sk + tkv - 1) / tkv, B * Hkv * splits), kTcThreads, L::dkdv,
           st>>>(qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dk),
                 static_cast<bf16*>(dv), ws, B, Sq, Sk, Hq, Hkv, scale,
                 causal, window, splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (splits > 1) {
      const int64_t slab = static_cast<int64_t>(B) * Sk * Hkv * D;
      const int64_t blocks = (slab + 255) / 256 < 4096 ? (slab + 255) / 256 : 4096;
      flash_bwd_sum_splits<<<static_cast<unsigned>(blocks), 256, 0, st>>>(
          ws, static_cast<bf16*>(dk), static_cast<bf16*>(dv), slab, splits);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  flash_bwd_dq_tc<D><<<dim3((Sq + TQD - 1) / TQD, B * Hq), kTcThreads, L::dq,
                       st>>>(qt, kt, vt, dot, lse, delta,
                             static_cast<bf16*>(dq), Sq, Sk, Hq, Hkv, scale,
                             causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), o and dout (B, Sq, Hq, D), dq like
// q, dk/dv like k; all contiguous, one dtype: bf16 (is_bf16 = 1) or f32.
// lse: the forward's f32 (B, Hq, Sq); delta: f32 (B, Hq, Sq) scratch. D is
// 32, 64, 128 or 256; Hq % Hkv == 0; window < 0 means no window. splits (bf16
// only; f32 takes 1) divides G = Hq / Hkv: the dK/dV blocks of a kv head
// split its G query heads, and above 1, ws is an f32 workspace of
// 2 splits B Sk Hkv D elements (null otherwise). Returns the first
// cudaGetLastError() that is not 0 after the launches.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* delta, void* dq, void* dk,
    void* dv, int is_bf16, int B, int Sq, int Sk, int Hq, int Hkv, int D,
    float scale, int causal, int window, int splits, void* ws,
    void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 ||
      (D != 32 && D != 64 && D != 128 && D != 256) ||
      splits < 1 || (Hq / Hkv) % splits != 0 ||
      (splits > 1 && (!is_bf16 || ws == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* w = static_cast<float*>(ws);
  if (is_bf16) {
    switch (D) {
      case 256:
        return launch_tc<256>(q, k, v, o, l, dout, dl, dq, dk, dv, w, B, Sq,
                              Sk, Hq, Hkv, scale, causal, window, splits, st);
      case 128:
        return launch_tc<128>(q, k, v, o, l, dout, dl, dq, dk, dv, w, B, Sq,
                              Sk, Hq, Hkv, scale, causal, window, splits, st);
      case 64:
        return launch_tc<64>(q, k, v, o, l, dout, dl, dq, dk, dv, w, B, Sq,
                             Sk, Hq, Hkv, scale, causal, window, splits, st);
      default:
        return launch_tc<32>(q, k, v, o, l, dout, dl, dq, dk, dv, w, B, Sq,
                             Sk, Hq, Hkv, scale, causal, window, splits, st);
    }
  }
  return launch_d<float>(D, q, k, v, o, l, dout, dl, dq, dk, dv, B, Sq, Sk,
                         Hq, Hkv, scale, causal, window, st);
}
