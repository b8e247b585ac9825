// Fused SwiGLU MLP: out = act(x Wg) * (x Wu) @ Wd, act in {silu, gelu_tanh}.
//
// Replaces: src/repro/kernels/fused_swiglu.py `_swiglu_kernel` /
// `fused_swiglu` (Pallas, TPU); in the model it stands in for the gated case
// of src/repro/models/mlp.py `mlp`.
//
// Bound on the card: bytes at decode, operations at prefill.  At the slice's
// decode batch (T = 8, D = 3072, F = 8192, fp32) every weight byte is read
// once for 2 * T flops per weight element: 302 MB per layer, ~90 us at
// 3.35 TB/s.  At prefill (T = 4096) the 618 GFLOP per layer take >= 9.2 ms
// at 67 TFLOP/s fp32.
//
// Design: two launches.  The TPU kernel keeps a (bm x D) f32 accumulator in
// VMEM across the F grid axis; at D = 3072 that is 1.5 MB for bm = 128, more
// than an SM holds, and GPU blocks carry nothing across the grid.  So:
//   A: h = act(x Wg) * (x Wu), tiled over (rows, F).  Both products share the
//      x tile and g, u never reach memory; h (T x F, f32) does.
//   B: out = h Wd, tiled over (rows, D), looping over F.
// Large T (prefill) runs both as a tiled SIMT GEMM: 256 threads, a 16-deep
// slice of each operand in shared memory per step and an 8 x 4 register
// tile per thread (128 x 64 block tiles).  Small T (decode, T <= 16) is
// bound by weight bytes and by how many loads are in flight, so it uses a
// skinny kernel instead: one block of 8 warps per 32 output columns, lane =
// column, so every weight row segment is one coalesced 128-byte load; the
// warps split each 256-deep K tile (32 k each, 32 loads in flight per lane),
// the x tile sits in shared memory, and the 8 warps' partial sums are added
// through shared memory in a fixed order.  (The tiled GEMM with 16 x 32
// tiles and a 16-deep slice ran at ~8% of HBM bandwidth at T = 8.)  Every
// output is summed in a fixed order, so results are deterministic (no
// atomics).  Ragged T, D and F are masked.  h costs T * F * 4 bytes written
// and read once (256 KB at decode, 134 MB at prefill): the price of not
// carrying an accumulator across F.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

enum Mode { kPlain = 0, kSilu = 1, kGeluTanh = 2 };

template <int MODE>
__device__ __forceinline__ float epilogue(float g, float u) {
  if constexpr (MODE == kSilu) {
    return g / (1.f + expf(-g)) * u;
  } else if constexpr (MODE == kGeluTanh) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * g * (1.f + tanhf(c * (g + 0.044715f * g * g * g))) * u;
  } else {
    return g;
  }
}

// C (M x N) = A (M x K) @ B0 (K x N); gated modes: act(A @ B0) * (A @ B1).
// All row-major and contiguous.  Tiled version, for large M.
constexpr int BM = 128, BN = 64, BK = 16;

template <typename TA, typename TB, typename TC, int MODE>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const TA* __restrict__ A, const TB* __restrict__ B0,
            const TB* __restrict__ B1, TC* __restrict__ C, int M, int N, int K) {
  constexpr bool kGated = MODE != kPlain;
  constexpr int TM = BM / 16, TN = BN / 16;
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs0[BK][BN];
  __shared__ float Bs1[kGated ? BK : 1][BN];

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc0[TM][TN] = {}, acc1[TM][TN] = {};   // acc1: gated modes only

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += kThreads) {
      const int r = idx / BK, kk = idx % BK;
      const int gm = m0 + r, gk = k0 + kk;
      As[kk][r] = (gm < M && gk < K) ? to_f(A[(long long)gm * K + gk]) : 0.f;
    }
    for (int idx = tid; idx < BK * BN; idx += kThreads) {
      const int kk = idx / BN, c = idx % BN;
      const int gk = k0 + kk, gn = n0 + c;
      const bool in = gk < K && gn < N;
      Bs0[kk][c] = in ? to_f(B0[(long long)gk * N + gn]) : 0.f;
      if constexpr (kGated) Bs1[kk][c] = in ? to_f(B1[(long long)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b0[TN], b1[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        b0[j] = Bs0[kk][tx + 16 * j];
        if constexpr (kGated) b1[j] = Bs1[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc0[i][j] += a[i] * b0[j];
          if constexpr (kGated) acc1[i][j] += a[i] * b1[j];
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      C[(long long)gm * N + gn] = from_f<TC>(epilogue<MODE>(acc0[i][j], acc1[i][j]));
    }
  }
}

// Skinny product for M <= kSkM rows: C = A @ B0 (or act(A @ B0) * (A @ B1)).
constexpr int kSkM = 16, kSkWarps = 8, kSkKT = 256, kSkKW = kSkKT / kSkWarps;

template <typename TA, typename TB, typename TC, int MODE>
__global__ void __launch_bounds__(kSkWarps * 32)
skinny_kernel(const TA* __restrict__ A, const TB* __restrict__ B0,
              const TB* __restrict__ B1, TC* __restrict__ C, int M, int N, int K) {
  constexpr bool kGated = MODE != kPlain;
  constexpr int kRed = kSkWarps * kSkM * 32 * (kGated ? 2 : 1);
  constexpr int kSmem = kRed > kSkM * kSkKT ? kRed : kSkM * kSkKT;
  __shared__ float smem[kSmem];
  float* As = smem;                                   // kSkM x kSkKT x tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * 32 + lane;
  const bool col_ok = n < N;

  float acc0[kSkM] = {}, acc1[kSkM] = {};         // acc1: gated modes only

  for (int k0 = 0; k0 < K; k0 += kSkKT) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kSkM * kSkKT; idx += kSkWarps * 32) {
      const int t = idx / kSkKT, kk = idx % kSkKT;
      As[idx] = (t < M && k0 + kk < K) ? to_f(A[(long long)t * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
    const int kw = k0 + warp * kSkKW;
    float b0[kSkKW], b1[kSkKW];
#pragma unroll
    for (int i = 0; i < kSkKW; ++i) {
      const bool in = col_ok && kw + i < K;
      b0[i] = in ? to_f(B0[(long long)(kw + i) * N + n]) : 0.f;
      if constexpr (kGated) b1[i] = in ? to_f(B1[(long long)(kw + i) * N + n]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kSkKW; ++i) {
      const float* a = As + warp * kSkKW + i;
#pragma unroll
      for (int t = 0; t < kSkM; ++t) {
        if (t < M) {
          acc0[t] += a[t * kSkKT] * b0[i];
          if constexpr (kGated) acc1[t] += a[t * kSkKT] * b1[i];
        }
      }
    }
  }

  __syncthreads();                                    // As is reused for the sums
  float* red0 = smem;                                 // [warp][t][lane]
  float* red1 = smem + kSkWarps * kSkM * 32;
#pragma unroll
  for (int t = 0; t < kSkM; ++t) {
    red0[(warp * kSkM + t) * 32 + lane] = acc0[t];
    if constexpr (kGated) red1[(warp * kSkM + t) * 32 + lane] = acc1[t];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < kSkM * 32; o += kSkWarps * 32) {
    const int t = o / 32, c = o % 32, gn = blockIdx.x * 32 + c;
    if (t >= M || gn >= N) continue;
    float g = 0.f, u = 0.f;
    for (int w = 0; w < kSkWarps; ++w) {
      g += red0[(w * kSkM + t) * 32 + c];
      if constexpr (kGated) u += red1[(w * kSkM + t) * 32 + c];
    }
    C[(long long)t * N + gn] = from_f<TC>(epilogue<MODE>(g, u));
  }
}

template <typename TA, typename TB, typename TC, int MODE>
int gemm(const void* A, const void* B0, const void* B1, void* C, int M, int N,
         int K, cudaStream_t st) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<TA, TB, TC, MODE><<<grid, kThreads, 0, st>>>(
      static_cast<const TA*>(A), static_cast<const TB*>(B0),
      static_cast<const TB*>(B1), static_cast<TC*>(C), M, N, K);
  return (int)cudaGetLastError();
}

template <typename TA, typename TB, typename TC, int MODE>
int skinny(const void* A, const void* B0, const void* B1, void* C, int M, int N,
           int K, cudaStream_t st) {
  skinny_kernel<TA, TB, TC, MODE><<<(N + 31) / 32, kSkWarps * 32, 0, st>>>(
      static_cast<const TA*>(A), static_cast<const TB*>(B0),
      static_cast<const TB*>(B1), static_cast<TC*>(C), M, N, K);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int act, const void* x, const void* wg, const void* wu,
             const void* wd, float* h, void* out, int T_, int D, int F,
             cudaStream_t st) {
  int err;
  if (T_ <= kSkM) {
    err = act == 0 ? skinny<T, T, float, kSilu>(x, wg, wu, h, T_, F, D, st)
                   : skinny<T, T, float, kGeluTanh>(x, wg, wu, h, T_, F, D, st);
    if (err) return err;
    return skinny<float, T, T, kPlain>(h, wd, nullptr, out, T_, D, F, st);
  }
  err = act == 0 ? gemm<T, T, float, kSilu>(x, wg, wu, h, T_, F, D, st)
                 : gemm<T, T, float, kGeluTanh>(x, wg, wu, h, T_, F, D, st);
  if (err) return err;
  return gemm<float, T, T, kPlain>(h, wd, nullptr, out, T_, D, F, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; act: 0 = silu, 1 = gelu_tanh.
// x: (T, D), wg/wu: (D, F), wd: (F, D), out: (T, D), all contiguous.
// h: (T, F) float32 scratch allocated by the caller.
int fused_swiglu(int dtype, int act, const void* x, const void* wg,
                 const void* wu, const void* wd, float* h, void* out, int T_,
                 int D, int F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (act != 0 && act != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch<float>(act, x, wg, wu, wd, h, out, T_, D, F, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(act, x, wg, wu, wd, h, out, T_, D, F, st);
  return (int)cudaErrorInvalidValue;
}

const char* fused_swiglu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
