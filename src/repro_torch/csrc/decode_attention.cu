// Decode attention: one query token per (batch row, head) against a KV cache.
//
// Replaces: src/repro/kernels/decode_attention.py `_decode_kernel` /
// `flash_decode` (Pallas, TPU), and computes what the model function it
// stands in for, src/repro/models/attention.py `decode_attention`, computes:
// GQA (q head h reads kv head h / G), per-row or shared cache_len, a sliding
// window (pos >= cache_len - window) and a tanh logit softcap.
//
// Bound on the card: bytes.  Each step reads the valid part of the K and V
// caches once (2 * cache_len * Hkv * D elements per batch row) for 4 * D
// flops per (head, key), about one flop per byte in fp32, far below the
// H100's ~20 fp32 flops per byte of HBM bandwidth.
//
// Design: one block of 8 warps per (b, h) row, so the slice's 8 x 32 rows
// give 256 blocks for 132 SMs.  The TPU kernel walks KV blocks on a
// sequential grid axis with (m, l, acc) in scratch; here each warp walks
// every 8th key of the row's valid range with its own online softmax, and
// the 8 partial (m, l, acc) are merged through shared memory at the end.
// Lanes split head_dim (lane d, d+32, ...), so every key row is read as
// contiguous, coalesced 128-byte segments straight from the cache in its
// model layout (B, S, Hkv, D) by strides: no transposed or padded copy of
// the cache is made, and keys outside [lo, cache_len) are never read.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kWarps = 8;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// NC = ceil(D / 32): head_dim elements held per lane.
template <typename T, int NC>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out,
                        const int* __restrict__ lens, int len_scalar,
                        int H, int Hkv, int S, int D,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        float scale, int window, float softcap) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hk = h / (H / Hkv);

  int len = lens ? lens[b] : len_scalar;
  len = min(len, S);
  const int lo = window > 0 ? max(0, len - window) : 0;

  float qr[NC], acc[NC];
  const T* qrow = q + ((long long)b * H + h) * D;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = lane + 32 * c;
    qr[c] = d < D ? to_f(qrow[d]) * scale : 0.f;
    acc[c] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  for (int pos = lo + warp; pos < len; pos += kWarps) {
    const T* krow = kb + pos * k_ss;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) s += qr[c] * to_f(krow[d]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (softcap > 0.f) s = softcap * tanhf(s / softcap);
    const float m_new = fmaxf(m, s);
    const float corr = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * corr + p;
    const T* vrow = vb + pos * v_ss;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      acc[c] = acc[c] * corr + (d < D ? p * to_f(vrow[d]) : 0.f);
    }
    m = m_new;
  }

  // merge the warps' partial softmaxes
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][NC * 32];
  if (lane == 0) { sm_m[warp] = m; sm_l[warp] = l; }
#pragma unroll
  for (int c = 0; c < NC; ++c) sm_acc[warp][lane + 32 * c] = acc[c];
  __syncthreads();

  float m_all = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, sm_m[w]);
  float l_all = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) l_all += sm_l[w] * expf(sm_m[w] - m_all);
  const float inv = 1.f / fmaxf(l_all, 1e-30f);
  T* orow = out + ((long long)b * H + h) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += sm_acc[w][d] * expf(sm_m[w] - m_all);
    orow[d] = from_f<T>(o * inv);
  }
}

template <typename T, int NC>
void launch(const void* q, const void* k, const void* v, void* out,
            const int* lens, int len_scalar, int B, int H, int Hkv, int S, int D,
            const long long* ks, const long long* vs, float scale, int window,
            float softcap, cudaStream_t stream) {
  dim3 grid(H, B);
  decode_attention_kernel<T, NC><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lens, len_scalar, H, Hkv, S, D, ks[0], ks[1], ks[2],
      vs[0], vs[1], vs[2], scale, window, softcap);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             const int* lens, int len_scalar, int B, int H, int Hkv, int S, int D,
             const long long* ks, const long long* vs, float scale, int window,
             float softcap, cudaStream_t stream) {
  if (D <= 64)
    launch<T, 2>(q, k, v, out, lens, len_scalar, B, H, Hkv, S, D, ks, vs, scale, window, softcap, stream);
  else if (D <= 96)
    launch<T, 3>(q, k, v, out, lens, len_scalar, B, H, Hkv, S, D, ks, vs, scale, window, softcap, stream);
  else if (D <= 128)
    launch<T, 4>(q, k, v, out, lens, len_scalar, B, H, Hkv, S, D, ks, vs, scale, window, softcap, stream);
  else if (D <= 256)
    launch<T, 8>(q, k, v, out, lens, len_scalar, B, H, Hkv, S, D, ks, vs, scale, window, softcap, stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q/out: (B, H, D) contiguous.  k/v:
// (B, S, Hkv, D) with unit stride on D; ks/vs hold the (B, S, Hkv) strides
// in elements.  lens: (B,) int32 on the device, or null to use len_scalar.
// window <= 0 means no window; softcap <= 0 means no cap.
int decode_attention(int dtype, const void* q, const void* k, const void* v,
                     void* out, const int* lens, int len_scalar, int B, int H,
                     int Hkv, int S, int D, const long long* ks,
                     const long long* vs, float scale, int window,
                     float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, lens, len_scalar, B, H, Hkv, S, D, ks, vs, scale, window, softcap, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, lens, len_scalar, B, H, Hkv, S, D, ks, vs, scale, window, softcap, st);
  return (int)cudaErrorInvalidValue;
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
