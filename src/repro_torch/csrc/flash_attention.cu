// Causal flash-attention forward with an optional sliding window and GQA.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_tpu, the
//   Pallas TPU kernel (body _kernel).
// What bounds it on the H100: at the serving prefill (Sq = Sk = 128,
//   head_dim 128) the q/k/v/o bytes and the score/value FLOPs are both small;
//   this version runs scalar f32 FMAs from shared memory, so its time is set
//   by the CUDA-core FMA rate and shared-memory loads, well above either
//   bound. It never writes the (Sq, Sk) score matrix to device memory.
// What the design does about it: one block per (batch * query head,
//   64-row query tile); each of its 4 warps owns 16 query rows and keeps
//   their online-softmax state (m, l) and f32 output accumulator in
//   registers across the key/value tiles, so nothing but P (a warp's own
//   rows) goes through shared memory between the two products. Key tiles
//   wholly past the causal diagonal or before the window are skipped: the
//   reference's masked blocks contribute exactly zero there. The TPU kernel's
//   semantics are kept: q is scaled in f32 before the dot, masked scores are
//   NEG_INF = -1e30 (not -inf), padded keys are masked by k_pos < sk, query
//   head r reads kv head r / G, and the epilogue floors the denominator at
//   1e-30. There is no q offset: prefill starts at position 0. No tensor
//   cores yet: a simple kernel that is right comes first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64, BK = 64, kThreads = 128;
constexpr int RPW = BQ / (kThreads / 32);  // query rows per warp: 16
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * BK);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int Hq, int Hkv, float scale, int causal, int window) {
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
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Sk, int Hq, int Hkv, float scale, int causal, int window,
           cudaStream_t st) {
  const size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * Hq, (Sq + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, Hq, Hkv, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), o (B, Sq, Hq, D); all contiguous,
// one dtype: bf16 (is_bf16 = 1) or f32. D is 64 or 128; Hq % Hkv == 0.
// window < 0 means no window. Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int is_bf16,
                                      int B, int Sq, int Sk, int Hq, int Hkv,
                                      int D, float scale, int causal,
                                      int window, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || (D != 64 && D != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return D == 128
        ? launch<__nv_bfloat16, 128>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, window, st)
        : launch<__nv_bfloat16, 64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, window, st);
  }
  return D == 128
      ? launch<float, 128>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, window, st)
      : launch<float, 64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, window, st);
}
