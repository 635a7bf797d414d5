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
//   (query, key) pairs, 10 B Hq pairs D FLOPs (bf16 operands; at
//   llama3.2-3b's 4 x 1024 tokens, 24 heads of 128, 0.13 TFLOP a layer).
//   This first design does them, and two recomputed ones, as scalar f32
//   FMAs from shared memory, well below the tensor cores' rate: it is
//   simple and exact first; mma.sync / wgmma is later work.
// Design: no atomics, so two calls give the same bits.
//   1. delta: one warp per (b, row, head), f32 (B, Hq, Sq).
//   2. dK, dV: one block of 256 threads per (key tile of 64, b, kv head),
//      earliest key tiles first (under a causal mask they see the most
//      query tiles). K and V stay in shared memory; the block walks the
//      query tiles that can see its keys and the G query heads of its
//      group, recomputes the 64 x 64 S and dP of each (thread (tx, ty)
//      owns rows ty + 16 i, columns tx + 16 j), writes P and dS to shared
//      memory, and accumulates dV += P^T dO and dK += dS^T (scale Q) in
//      registers (key rows ty + 16 i, dims tx + 16 j).
//   3. dQ: one block per (query tile of 64, b, query head), latest tiles
//      first; it walks the forward's key tiles, recomputes S, dP and dS,
//      and accumulates dQ += dS K in registers, scaled at the end.
//   Tiles are f32 in shared memory with rows padded by one word (D + 1),
//   so the 16 key rows a warp reads at one dim fall in 16 banks:
//   165,888 B at D = 128. Head dims 32, 64 and 128; 256 does not fit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64, BK = 64, kThreads = 256, kWarps = kThreads / 32;
static_assert(BQ == BK, "load_tile fills BQ rows of a query or key tile");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int D>
constexpr size_t smem_bytes() {  // Q, dO, K, V; P, dS; lse, delta
  return sizeof(float) *
         ((2 * BQ + 2 * BK) * (D + 1) + 2 * BQ * (BK + 1) + 2 * BQ);
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

// rows [r0, r0 + BQ) of head h of a (B, S, H, D) tensor into a (BQ, D + 1)
// f32 tile, times mul; zeros past S
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int r0, int S, int64_t stride,
                                          float mul) {
  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
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
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = Qs[(ty + 16 * i) * (D + 1) + d];
      oa[i] = dOs[(ty + 16 * i) * (D + 1) + d];
      kb[i] = Ks[(tx + 16 * i) * (D + 1) + d];
      vb[i] = Vs[(tx + 16 * i) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qp = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, kp = k0 + c;
      bool ok = qp < Sq && kp < Sk;
      if (causal) ok = ok && kp <= qp;
      if (window >= 0) ok = ok && kp > qp - window;
      const float p = ok ? expf(s[i][j] - lse_s[r]) : 0.f;
      Ps[r * (BK + 1) + c] = p;
      dSs[r * (BK + 1) + c] = p * (dp[i][j] - dl_s[r]);
    }
  }
}

struct Smem {
  float *Qs, *dOs, *Ks, *Vs, *Ps, *dSs, *lse_s, *dl_s;
};

template <int D>
__device__ __forceinline__ Smem carve(float* smem) {
  Smem m;
  m.Qs = smem;
  m.dOs = m.Qs + BQ * (D + 1);
  m.Ks = m.dOs + BQ * (D + 1);
  m.Vs = m.Ks + BK * (D + 1);
  m.Ps = m.Vs + BK * (D + 1);
  m.dSs = m.Ps + BQ * (BK + 1);
  m.lse_s = m.dSs + BQ * (BK + 1);
  m.dl_s = m.lse_s + BQ;
  return m;
}

// Q (scaled), dO, lse and delta of query rows [q0, q0 + BQ) of head h
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
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
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
  float aK[4][DJ], aV[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
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
        float p[4], ds[4], o[DJ], x[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = m.Ps[r * (BK + 1) + ty + 16 * i];
          ds[i] = m.dSs[r * (BK + 1) + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          o[j] = m.dOs[r * (D + 1) + tx + 16 * j];
          x[j] = m.Qs[r * (D + 1) + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
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
  for (int i = 0; i < 4; ++i) {
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
  float aQ[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
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
      float ds[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = m.dSs[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = m.Ks[c * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < DJ; ++j) aQ[i][j] = fmaf(ds[i], kv[j], aQ[i][j]);
      }
    }
  }
  const int64_t qs = static_cast<int64_t>(Hq) * D;
  const int64_t qoff = (static_cast<int64_t>(b) * Sq * Hq + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
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

}  // namespace

// q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), o and dout (B, Sq, Hq, D), dq like
// q, dk/dv like k; all contiguous, one dtype: bf16 (is_bf16 = 1) or f32.
// lse: the forward's f32 (B, Hq, Sq); delta: f32 (B, Hq, Sq) scratch. D is
// 32, 64 or 128; Hq % Hkv == 0; window < 0 means no window. Returns the
// first cudaGetLastError() that is not 0 after the three launches.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* delta, void* dq, void* dk,
    void* dv, int is_bf16, int B, int Sq, int Sk, int Hq, int Hkv, int D,
    float scale, int causal, int window, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || (D != 32 && D != 64 && D != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (is_bf16) {
    return launch_d<__nv_bfloat16>(D, q, k, v, o, l, dout, dl, dq, dk, dv, B,
                                   Sq, Sk, Hq, Hkv, scale, causal, window, st);
  }
  return launch_d<float>(D, q, k, v, o, l, dout, dl, dq, dk, dv, B, Sq, Sk,
                         Hq, Hkv, scale, causal, window, st);
}
