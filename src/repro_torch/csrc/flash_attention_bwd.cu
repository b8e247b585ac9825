// Flash attention backward: dQ, dK, dV for causal (or full), sliding-window
// and GQA attention, recomputing the probabilities from the forward's
// logsumexp.
//
// Replaces: the gradient of src/repro/models/attention.py
// `blocked_causal_attention`, which repro takes by XLA autodiff; its
// forward is src/repro/kernels/flash_attention.py `_attn_kernel` (Pallas,
// TPU), ported in flash_attention.cu.  repro has no backward Pallas kernel;
// the port's forward runs through a kernel, so its gradient needs one.
//
// Math (S = scale * Q K^T, P = softmax(S) under the mask, O = P V):
//   Dvec_i = rowsum(dO_i * O_i)
//   P_ij   = exp(S_ij - LSE_i)            (LSE from the forward)
//   dV     = P^T dO,  dP = dO V^T,  dS = P * (dP - Dvec)
//   dQ     = scale * dS K,  dK = scale * dS^T Q
// A logit softcap would need tanh' inside dS; it has no kernel here, and the
// Python wrapper raises NotImplementedError for it.
//
// Bound on the card: operations.  The five products come to 10 * D flops
// per (query, valid key) pair, 2.5x the forward's 4 * D; at the slice's
// training shape (2, 256, 32, 96) causal that is 0.8 GFLOP against 25 MB
// of q/k/v/o/dO/dq/dk/dv/LSE, ~32 flops per byte, above the fp32 ridge of
// ~20.
//
// Design: three launches, no atomics, so the result is deterministic.
//   1. one warp per (b, h, row): Dvec = rowsum(dO * O) into a (B, H, S)
//      float32 scratch.
//   2. dK/dV: one block of 256 threads per (64-key tile, kv head, batch
//      row).  K and V stay in shared memory; the block loops over the q
//      heads of its GQA group and over the 64-query tiles that can see its
//      keys (causal: q >= k; window: q < k + window), recomputing S^T and
//      dP^T as 4 x 4 register tiles per thread, writing P^T and dS^T to
//      shared memory, then accumulating dV += P^T dO and dK += dS^T Q in
//      4 x (D/16) register tiles.  Summing the group's heads inside the
//      block is what GQA's shared K/V needs, without atomics.
//   3. dQ: one block per (64-query tile, head, batch row), looping over the
//      key tiles the queries can see, recomputing S and dP, and
//      accumulating dQ += dS K.
// Products 1-2 recompute S and dP twice (once per pass): 14 * D flops per
// pair instead of the 10 * D minimum, the price of no atomics.  q, k, v and
// dO are read in the model layout (B, S, H, D) by strides; the ragged tail
// of S is masked.  Plain SIMT fp32; head_dim <= 128.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64, BK = 64, kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides { long long b, s, h; };

__device__ __forceinline__ bool visible(int qpos, int kpos, int S, int causal, int window) {
  bool ok = qpos < S && kpos < S;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// Dvec[(b * H + h) * S + i] = sum_d dO[b, i, h, d] * O[b, i, h, d]
template <typename T>
__global__ void __launch_bounds__(kThreads)
row_dot_kernel(const T* __restrict__ out, const T* __restrict__ dout,
               float* __restrict__ dvec, int B, int S, int H, int D, Strides os,
               Strides ds) {
  const long long rows = (long long)B * H * S;
  const long long r = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  const int i = (int)(r % S), h = (int)((r / S) % H), b = (int)(r / ((long long)S * H));
  const T* orow = out + b * os.b + i * os.s + h * os.h;
  const T* drow = dout + b * ds.b + i * ds.s + h * ds.h;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += to_f(orow[d]) * to_f(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dvec[r] = acc;
}

// NDK = ceil(D / 16): head_dim columns of an accumulator tile per thread.
template <typename T, int NDK>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ dvec, T* __restrict__ dk, T* __restrict__ dv,
            int S, int H, int Hkv, int D, Strides qs, Strides ks, Strides vs,
            Strides dos, float scale, int causal, int window) {
  extern __shared__ float smem[];
  const int DS = D + 1;                       // padded row stride: no bank conflicts
  float* Ks = smem;                           // BK x DS
  float* Vs = Ks + BK * DS;                   // BK x DS
  float* Qs = Vs + BK * DS;                   // BQ x DS
  float* Os = Qs + BQ * DS;                   // BQ x DS (dO)
  float* Ps = Os + BQ * DS;                   // BK x (BQ + 1): P^T
  float* dSs = Ps + BK * (BQ + 1);            // BK x (BQ + 1): dS^T
  float* Ls = dSs + BK * (BQ + 1);            // BQ: LSE of the q tile
  float* Dv = Ls + BQ;                        // BQ: Dvec of the q tile

  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  for (int idx = tid; idx < BK * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const bool in = k0 + r < S;
    Ks[r * DS + d] = in ? to_f(kb[(k0 + r) * ks.s + d]) : 0.f;
    Vs[r * DS + d] = in ? to_f(vb[(k0 + r) * vs.s + d]) : 0.f;
  }

  float dK[4][NDK], dV[4][NDK];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NDK; ++c) dK[i][c] = dV[i][c] = 0.f;

  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S, k0 + BK - 1 + window) : S;

  for (int h = hk * G; h < (hk + 1) * G; ++h) {
    const T* qb = q + b * qs.b + h * qs.h;
    const T* ob = dout + b * dos.b + h * dos.h;
    const float* lb = lse + ((long long)b * H + h) * S;
    const float* db = dvec + ((long long)b * H + h) * S;
    for (int q0 = q_lo; q0 < q_hi; q0 += BQ) {
      __syncthreads();   // previous tile's Qs/Os/Ps/dSs reads are done (and Ks/Vs loaded)
      for (int idx = tid; idx < BQ * D; idx += kThreads) {
        const int r = idx / D, d = idx % D;
        const bool in = q0 + r < S;
        Qs[r * DS + d] = in ? to_f(qb[(q0 + r) * qs.s + d]) : 0.f;
        Os[r * DS + d] = in ? to_f(ob[(q0 + r) * dos.s + d]) : 0.f;
      }
      if (tid < BQ) {
        const bool in = q0 + tid < S;
        Ls[tid] = in ? lb[q0 + tid] : 0.f;
        Dv[tid] = in ? db[q0 + tid] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T: rows = keys ty + 16 i, columns = queries tx + 16 j
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float ka[4], va[4], qa[4], oa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ka[i] = Ks[(ty + 16 * i) * DS + d];
          va[i] = Vs[(ty + 16 * i) * DS + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qa[j] = Qs[(tx + 16 * j) * DS + d];
          oa[j] = Os[(tx + 16 * j) * DS + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] += ka[i] * qa[j];
            dpt[i][j] += va[i] * oa[j];
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = tx + 16 * j;
          const bool ok = visible(q0 + qc, k0 + kr, S, causal, window);
          const float p = ok ? expf(st[i][j] * scale - Ls[qc]) : 0.f;
          Ps[kr * (BQ + 1) + qc] = p;
          dSs[kr * (BQ + 1) + qc] = p * (dpt[i][j] - Dv[qc]);
        }
      }
      __syncthreads();

      for (int qq = 0; qq < BQ; ++qq) {
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = Ps[(ty + 16 * i) * (BQ + 1) + qq];
          ds[i] = dSs[(ty + 16 * i) * (BQ + 1) + qq];
        }
#pragma unroll
        for (int c = 0; c < NDK; ++c) {
          const int d = tx + 16 * c;
          const float o = d < D ? Os[qq * DS + d] : 0.f;
          const float qv = d < D ? Qs[qq * DS + d] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dV[i][c] += p[i] * o;
            dK[i][c] += ds[i] * qv;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= S) continue;
    const long long row = (((long long)b * S + kpos) * Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < NDK; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        dk[row + d] = from_f<T>(dK[i][c] * scale);
        dv[row + d] = from_f<T>(dV[i][c]);
      }
    }
  }
}

template <typename T, int NDK>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ dvec, T* __restrict__ dq, int S, int H,
          int Hkv, int D, Strides qs, Strides ks, Strides vs, Strides dos,
          float scale, int causal, int window) {
  extern __shared__ float smem[];
  const int DS = D + 1;
  float* Qs = smem;                           // BQ x DS
  float* Os = Qs + BQ * DS;                   // BQ x DS (dO)
  float* Ks = Os + BQ * DS;                   // BK x DS
  float* Vs = Ks + BK * DS;                   // BK x DS
  float* dSs = Vs + BK * DS;                  // BQ x (BK + 1)
  float* Ls = dSs + BQ * (BK + 1);            // BQ
  float* Dv = Ls + BQ;                        // BQ

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* ob = dout + b * dos.b + h * dos.h;
  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const bool in = q0 + r < S;
    Qs[r * DS + d] = in ? to_f(qb[(q0 + r) * qs.s + d]) : 0.f;
    Os[r * DS + d] = in ? to_f(ob[(q0 + r) * dos.s + d]) : 0.f;
  }
  if (tid < BQ) {
    const bool in = q0 + tid < S;
    Ls[tid] = in ? lse[((long long)b * H + h) * S + q0 + tid] : 0.f;
    Dv[tid] = in ? dvec[((long long)b * H + h) * S + q0 + tid] : 0.f;
  }

  float dQ[4][NDK];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NDK; ++c) dQ[i][c] = 0.f;

  const int kv_hi = causal ? min(S, q0 + BQ) : S;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BK) {
    __syncthreads();   // previous tile's Ks/dSs reads are done (and Qs/Os loaded)
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const bool in = k0 + r < S;
      Ks[r * DS + d] = in ? to_f(kb[(k0 + r) * ks.s + d]) : 0.f;
      Vs[r * DS + d] = in ? to_f(vb[(k0 + r) * vs.s + d]) : 0.f;
    }
    __syncthreads();

    // S and dP: rows = queries ty + 16 i, columns = keys tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qa[4], oa[4], ka[4], va[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = Qs[(ty + 16 * i) * DS + d];
        oa[i] = Os[(ty + 16 * i) * DS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ka[j] = Ks[(tx + 16 * j) * DS + d];
        va[j] = Vs[(tx + 16 * j) * DS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += qa[i] * ka[j];
          dp[i][j] += oa[i] * va[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = tx + 16 * j;
        const bool ok = visible(q0 + qr, k0 + kc, S, causal, window);
        const float p = ok ? expf(s[i][j] * scale - Ls[qr]) : 0.f;
        dSs[qr * (BK + 1) + kc] = p * (dp[i][j] - Dv[qr]);
      }
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < NDK; ++c) {
        const int d = tx + 16 * c;
        const float kv = d < D ? Ks[kk * DS + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) dQ[i][c] += ds[i] * kv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
    T* row = dq + (((long long)b * S + qpos) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NDK; ++c) {
      const int d = tx + 16 * c;
      if (d < D) row[d] = from_f<T>(dQ[i][c] * scale);
    }
  }
}

template <typename T, int NDK>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* dvec, void* dq, void* dk,
           void* dv, int B, int S, int H, int Hkv, int D, Strides qs, Strides ks,
           Strides vs, Strides dos, float scale, int causal, int window,
           cudaStream_t st) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const Strides os{(long long)S * H * D, (long long)H * D, D};   // out is contiguous
  const long long rows = (long long)B * H * S;
  row_dot_kernel<T><<<(unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)), kThreads, 0, st>>>(
      static_cast<const T*>(out), dot, dvec, B, S, H, D, os, dos);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_kv = sizeof(float) * (size_t)(4 * 64 * (D + 1) + 2 * BK * (BQ + 1) + 2 * BQ);
  err = cudaFuncSetAttribute(dkdv_kernel<T, NDK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  dkdv_kernel<T, NDK><<<dim3((S + BK - 1) / BK, Hkv, B), kThreads, smem_kv, st>>>(
      qt, kt, vt, dot, lse, dvec, static_cast<T*>(dk), static_cast<T*>(dv), S, H, Hkv, D,
      qs, ks, vs, dos, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_q = sizeof(float) * (size_t)(4 * 64 * (D + 1) + BQ * (BK + 1) + 2 * BQ);
  err = cudaFuncSetAttribute(dq_kernel<T, NDK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  dq_kernel<T, NDK><<<dim3((S + BQ - 1) / BQ, H, B), kThreads, smem_q, st>>>(
      qt, kt, vt, dot, lse, dvec, static_cast<T*>(dq), S, H, Hkv, D, qs, ks, vs, dos,
      scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* out,
             const void* dout, const float* lse, float* dvec, void* dq, void* dk,
             void* dv, int B, int S, int H, int Hkv, int D, Strides qs, Strides ks,
             Strides vs, Strides dos, float scale, int causal, int window,
             cudaStream_t st) {
  if (D <= 64)
    return launch<T, 4>(q, k, v, out, dout, lse, dvec, dq, dk, dv, B, S, H, Hkv, D, qs, ks, vs, dos, scale, causal, window, st);
  if (D <= 96)
    return launch<T, 6>(q, k, v, out, dout, lse, dvec, dq, dk, dv, B, S, H, Hkv, D, qs, ks, vs, dos, scale, causal, window, st);
  if (D <= 128)
    return launch<T, 8>(q, k, v, out, dout, lse, dvec, dq, dk, dv, B, S, H, Hkv, D, qs, ks, vs, dos, scale, causal, window, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q/dout: (B, S, H, D), k/v: (B, S, Hkv, D),
// unit stride on D, (B, S, H) strides in elements in qs/ks/vs/dos.  out: the
// forward's (B, S, H, D) output, contiguous; lse: its (B, H, S) float32
// logsumexp; dvec: (B, H, S) float32 scratch.  dq: (B, S, H, D) and dk/dv:
// (B, S, Hkv, D) contiguous outputs.  window <= 0: no window.  D <= 128.
int flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const void* lse,
                        void* dvec, void* dq, void* dk, void* dv, int B, int S,
                        int H, int Hkv, int D, const long long* qs,
                        const long long* ks, const long long* vs,
                        const long long* dos, float scale, int causal,
                        int window, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides q3{qs[0], qs[1], qs[2]}, k3{ks[0], ks[1], ks[2]}, v3{vs[0], vs[1], vs[2]},
      d3{dos[0], dos[1], dos[2]};
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(dvec);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, dout, lf, df, dq, dk, dv, B, S, H, Hkv, D, q3, k3, v3, d3, scale, causal, window, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, dout, lf, df, dq, dk, dv, B, S, H, Hkv, D, q3, k3, v3, d3, scale, causal, window, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
