// Flash attention forward: causal (or full), sliding window, tanh softcap, GQA.
//
// Replaces: src/repro/kernels/flash_attention.py `_attn_kernel` /
// `flash_attention` (Pallas, TPU); in the model it stands in for
// src/repro/models/attention.py `blocked_causal_attention`.
//
// Bound on the card: operations.  At the slice's prefill, (8 x 32 heads,
// S = 512, D = 96) causal, 4 * D flops per (query, valid key) come to about
// 13 GFLOP against 50 MB of q/k/v/o, ~250 flops per byte, well above the
// fp32 ridge of the H100 (67 TFLOP/s over 3.35 TB/s = ~20).
//
// Design: one block of 256 threads per (64-query tile, head, batch row).
// The TPU kernel carries (m, l, acc) in VMEM scratch across a sequential kv
// grid axis; GPU blocks carry nothing across the grid, so the block loops
// over 64-key tiles itself, from the window's first key to the causal bound
// only (fully masked tiles are never loaded).  The q tile stays in shared
// memory; K, V and the probability tile P pass through shared memory, and
// each thread keeps a 4 x 4 score tile and a 4 x (D/16) output tile in
// registers (rows ty + 16 i, key columns / head_dim columns tx + 16 j), so
// every shared-memory operand is reused 4 times per load.  The row max and
// row sum of the online softmax reduce over the 16 lanes that share a row
// with warp shuffles.  q/k/v are read in the model layout (B, S, H, D) by
// strides (no transposed copy) and the ragged tail of S is masked, not
// padded.  Plain SIMT fp32 FMAs: wgmma/TMA are later work.  For training
// the caller passes a (B, H, S) float32 buffer and the kernel writes each
// row's logsumexp m + log(l) of the scaled scores there, which the backward
// (flash_attention_bwd.cu) uses to recompute the probabilities; serving
// passes null.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64, BK = 64, kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides { long long b, s, h; };

// NDK = ceil(D / 16): head_dim columns of the output tile held per thread.
template <typename T, int NDK>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int S, int H, int Hkv, int D, Strides qs, Strides ks,
                       Strides vs, float scale, int causal, int window,
                       float softcap) {
  extern __shared__ float smem[];
  const int DS = D + 1;                       // padded row stride: no bank conflicts
  float* Qs = smem;                           // BQ x DS
  float* Ks = Qs + BQ * DS;                   // BK x DS
  float* Vs = Ks + BK * DS;                   // BK x D
  float* Ps = Vs + BK * D;                    // BQ x (BK + 1)

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  const T* qb = q + b * qs.b + h * qs.h;
  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    Qs[r * DS + d] = q0 + r < S ? to_f(qb[(q0 + r) * qs.s + d]) : 0.f;
  }

  float m[4], l[4], acc[4][NDK];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NDK; ++c) acc[i][c] = 0.f;
  }

  const int kv_hi = causal ? min(S, q0 + BQ) : S;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BK) {
    __syncthreads();   // previous tile's Ks/Vs/Ps reads are done (and Qs is loaded)
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const bool in = k0 + r < S;
      Ks[r * DS + d] = in ? to_f(kb[(k0 + r) * ks.s + d]) : 0.f;
      Vs[r * D + d] = in ? to_f(vb[(k0 + r) * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * DS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * DS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += a[i] * bk[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool valid = kpos < S;
        if (causal) valid = valid && kpos <= qpos;
        if (window > 0) valid = valid && kpos > qpos - window;
        s[i][j] = valid ? x : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rsum += p;
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NDK; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    for (int c2 = 0; c2 < BK; ++c2) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * (BK + 1) + c2];
#pragma unroll
      for (int c = 0; c < NDK; ++c) {
        const int d = tx + 16 * c;
        const float vv = d < D ? Vs[c2 * D + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += p[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0) lse[((long long)b * H + h) * S + qpos] = m[i] + logf(l[i]);
    T* orow = out + (((long long)b * S + qpos) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NDK; ++c) {
      const int d = tx + 16 * c;
      if (d < D) orow[d] = from_f<T>(acc[i][c] * inv);
    }
  }
}

template <typename T, int NDK>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
           int H, int Hkv, int D, Strides qs, Strides ks, Strides vs, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(2 * BQ * (D + 1) + BK * D + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, NDK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, NDK><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, S, H, Hkv, D, qs, ks, vs, scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
             int H, int Hkv, int D, Strides qs, Strides ks, Strides vs, float scale,
             int causal, int window, float softcap, cudaStream_t st) {
  if (D <= 64) return launch<T, 4>(q, k, v, out, lse, B, S, H, Hkv, D, qs, ks, vs, scale, causal, window, softcap, st);
  if (D <= 96) return launch<T, 6>(q, k, v, out, lse, B, S, H, Hkv, D, qs, ks, vs, scale, causal, window, softcap, st);
  if (D <= 128) return launch<T, 8>(q, k, v, out, lse, B, S, H, Hkv, D, qs, ks, vs, scale, causal, window, softcap, st);
  if (D <= 256) return launch<T, 16>(q, k, v, out, lse, B, S, H, Hkv, D, qs, ks, vs, scale, causal, window, softcap, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q: (B, S, H, D), k/v: (B, S, Hkv, D),
// each with unit stride on D and (B, S, H) strides in elements in qs/ks/vs.
// out: (B, S, H, D) contiguous.  window <= 0: no window; softcap <= 0: none.
// lse: null, or (B, H, S) float32 for the rows' logsumexp.
int flash_attention(int dtype, const void* q, const void* k, const void* v,
                    void* out, void* lse, int B, int S, int H, int Hkv, int D,
                    const long long* qs, const long long* ks, const long long* vs,
                    float scale, int causal, int window, float softcap,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides q3{qs[0], qs[1], qs[2]}, k3{ks[0], ks[1], ks[2]}, v3{vs[0], vs[1], vs[2]};
  float* lsef = static_cast<float*>(lse);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, lsef, B, S, H, Hkv, D, q3, k3, v3, scale, causal, window, softcap, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, lsef, B, S, H, Hkv, D, q3, k3, v3, scale, causal, window, softcap, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
