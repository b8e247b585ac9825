// SwiGLU backward, elementwise part: from the gate and up products
// g = x Wg, u = x Wu and the hidden cotangent dh = dout Wd^T, writes
//   h  = act(g) * u            (for dWd = h^T dout)
//   du = dh * act(g)
//   dg = dh * u * act'(g)
// for act in {silu, gelu_tanh}, all float32.
//
// Replaces: the gradient of the gated case of src/repro/models/mlp.py `mlp`,
// which repro takes by XLA autodiff; its forward is
// src/repro/kernels/fused_swiglu.py `_swiglu_kernel` (Pallas, TPU), ported
// in fused_swiglu.cu.  The products around this kernel (dh = dout Wd^T,
// dWd = h^T dout, dWg = x^T dg, dWu = x^T du, dx = dg Wg^T + du Wu^T, and
// the recomputed g and u) stay matrix products, as repro leaves its MLP
// gradient products to XLA.
//
// Bound on the card: bytes.  Three float32 inputs read and three written
// per element: at the slice's training shape (T = 512, F = 8192) 101 MB,
// >= 30 us at 3.35 TB/s.
//
// Design: one thread per element (four per thread, as float4, when the
// buffers are 16-byte aligned and the count divides by four), a grid-stride
// loop; the arithmetic is the same expression, in the same order, as the
// plain version `naive_swiglu_act_bwd` (repro_torch/kernels/ref.py).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Out3 { float dg, du, h; };

__device__ __forceinline__ Out3 swiglu_grad(float g, float u, float dh, int act) {
  float a, da;
  if (act == 0) {
    const float s = 1.f / (1.f + expf(-g));
    a = g * s;
    da = s * (1.f + g * (1.f - s));
  } else {
    const float c = 0.7978845608028654f;   // sqrt(2 / pi)
    const float t = tanhf(c * (g + 0.044715f * g * g * g));
    a = 0.5f * g * (1.f + t);
    da = 0.5f * (1.f + t) + 0.5f * g * (1.f - t * t) * c * (1.f + 0.134145f * g * g);
  }
  return {dh * u * da, dh * a, a * u};
}

__global__ void __launch_bounds__(kThreads)
swiglu_bwd_vec(const float4* __restrict__ g, const float4* __restrict__ u,
               const float4* __restrict__ dh, float4* __restrict__ dg,
               float4* __restrict__ du, float4* __restrict__ h, long long n4, int act) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kThreads) {
    const float4 gv = g[i], uv = u[i], dv = dh[i];
    const Out3 a = swiglu_grad(gv.x, uv.x, dv.x, act), b = swiglu_grad(gv.y, uv.y, dv.y, act),
               c = swiglu_grad(gv.z, uv.z, dv.z, act), d = swiglu_grad(gv.w, uv.w, dv.w, act);
    dg[i] = make_float4(a.dg, b.dg, c.dg, d.dg);
    du[i] = make_float4(a.du, b.du, c.du, d.du);
    h[i] = make_float4(a.h, b.h, c.h, d.h);
  }
}

__global__ void __launch_bounds__(kThreads)
swiglu_bwd_any(const float* __restrict__ g, const float* __restrict__ u,
               const float* __restrict__ dh, float* __restrict__ dg,
               float* __restrict__ du, float* __restrict__ h, long long n, int act) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const Out3 o = swiglu_grad(g[i], u[i], dh[i], act);
    dg[i] = o.dg;
    du[i] = o.du;
    h[i] = o.h;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

}  // namespace

extern "C" {

// act: 0 = silu, 1 = gelu_tanh.  g, u, dh: n float32 inputs; dg, du, h: n
// float32 outputs; all contiguous.
int swiglu_bwd(int act, const void* g, const void* u, const void* dh, void* dg,
               void* du, void* h, long long n, void* stream) {
  if ((act != 0 && act != 1) || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0 && aligned16(g) && aligned16(u) && aligned16(dh) &&
                   aligned16(dg) && aligned16(du) && aligned16(h);
  const long long work = vec ? n / 4 : n;
  const long long blocks = (work + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(blocks < 132 * 64 ? blocks : 132 * 64);
  if (vec)
    swiglu_bwd_vec<<<grid, kThreads, 0, st>>>(
        static_cast<const float4*>(g), static_cast<const float4*>(u),
        static_cast<const float4*>(dh), static_cast<float4*>(dg),
        static_cast<float4*>(du), static_cast<float4*>(h), work, act);
  else
    swiglu_bwd_any<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(g), static_cast<const float*>(u),
        static_cast<const float*>(dh), static_cast<float*>(dg),
        static_cast<float*>(du), static_cast<float*>(h), n, act);
  return (int)cudaGetLastError();
}

const char* fused_swiglu_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
