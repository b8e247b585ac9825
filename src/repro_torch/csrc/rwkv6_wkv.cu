// RWKV-6 WKV recurrence, serial in time, from S = 0.
//
// Replaces: src/repro/kernels/rwkv6_wkv.py `_wkv_kernel` / `rwkv6_wkv`
// (Pallas, TPU).  For each row (b, h), key i and value column j < d:
//   out_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j]  = w_t[i] * S[i][j] + k_t[i] * v_t[j]
// r, k, v, w: (B, H, S, d) float32, read by strides with d contiguous (the
// model hands over head views of its (B, S, H*d) projections); u: (H, d);
// out: (B, H, S, d) float32, contiguous, before ln_x.  d is 32 or 64.
//
// Bound on the card, at the served rwkv6-7b prefill (B 8, H 64, S 512, d 64):
//   bytes: read r, k, v, w and write out: 5 * 4 * B * S * H * d = 335 MB,
//     >= 0.100 ms at 3.35 TB/s;
//   fp32: ~4 d^2 operations per (row, step) = 4.3 GFLOP, >= 0.064 ms at
//     67 TFLOP/s.
//
// Design.  The TPU kernel walks a (row, chunk) grid in order, carries the
// (d, d) state in VMEM and expands each chunk into matmul form with
// exp(+-cumsum(log w)) factors, which needs the model's clamp of the decay
// logit to stay in fp32 range.  Here the recurrence runs step by step, so
// no exponential of a cumulative sum appears and the result is the
// recurrence's for any w in [0, 1], clamped or not.
//   * Value columns are independent: S[:, j] needs only r_t, k_t, w_t and
//     v_t[j].  A block owns one row: d threads, in groups of kLanes = 4
//     lanes that share kCols = 4 columns and split the d keys four ways
//     (lane q holds keys 16 m + 4 q + c, so the four lanes' float4 reads
//     hit distinct banks).  A thread keeps (d / 4) x 4 state entries in
//     registers.
//   * What limits this kernel is the path from shared memory to registers
//     (128 bytes a clock on an SM), not arithmetic: every step each thread
//     reads r, k and w of its keys.  Four columns a thread reuse each read
//     four times, 3.25 bytes a state entry a step against 12 with one
//     column a thread (the first design, 0.53 ms at the prefill shape;
//     PERF.md).  Each entry then costs three fp32 operations a step
//     (readout fma, k v, update fma) and the two paths are about even.
//   * r, k, w and v of kRun steps are copied into shared memory with
//     cp.async, two runs in flight: the copy of run n + 1 overlaps the
//     recurrence over run n.
//   * The bonus term sum_i r_t[i] u[i] k_t[i] is the same for every column:
//     one warp reduction per step, before the run's recurrence, computes it.
//   * The four lanes' partial readouts of their four columns are summed by
//     a transposing butterfly (three shuffles, after which lane q holds
//     column q); outputs go through shared memory to coalesced float4
//     stores.
#include <cuda_runtime.h>

namespace {

constexpr int kRun = 16;     // time steps per staged run; two runs in flight
constexpr int kLanes = 4;    // lanes that split the keys of a column group
constexpr int kCols = 4;     // value columns a thread owns

struct Strides {
  long long b, h, s;
};

template <int D>
struct Stage {
  float in[2][4][kRun][D];   // r, k, w, v of two runs
  float out[kRun][D];
  float bonus[kRun];
  float u[D];
};

__device__ __forceinline__ void copy16_async(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

template <int D>
__global__ void __launch_bounds__(D)
rwkv6_wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, float* __restrict__ out, int H, int S,
                 Strides rs, Strides ks, Strides vs, Strides ws) {
  constexpr int kThreads = D / kCols * kLanes;   // = D
  constexpr int kVec = D / 4;                    // float4s in a row of d
  constexpr int kGroups = D / 16;                // float4 groups of keys a lane owns
  __shared__ __align__(16) Stage<D> sm;

  const int tid = threadIdx.x;
  const int q = tid % kLanes;                    // which keys
  const int col0 = tid / kLanes * kCols;         // first of the thread's columns
  const int lane = tid % 32, warp = tid / 32;
  const long long b = blockIdx.x / H, h = blockIdx.x % H;
  const float* src[4] = {r + b * rs.b + h * rs.h, k + b * ks.b + h * ks.h,
                         w + b * ws.b + h * ws.h, v + b * vs.b + h * vs.h};
  const long long step[4] = {rs.s, ks.s, ws.s, vs.s};
  float* orow = out + (long long)blockIdx.x * S * D;
  sm.u[tid] = u[h * D + tid];

  auto stage = [&](int buf, int t0, int steps) {
    for (int f = tid; f < steps * kVec; f += kThreads) {
      const int s = f / kVec, c4 = (f % kVec) * 4;
#pragma unroll
      for (int x = 0; x < 4; ++x)
        copy16_async(&sm.in[buf][x][s][c4], src[x] + (t0 + s) * step[x] + c4);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float st[kGroups][4][kCols];
#pragma unroll
  for (int m = 0; m < kGroups; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int j = 0; j < kCols; ++j) st[m][c][j] = 0.f;

  const int n_runs = (S + kRun - 1) / kRun;
  stage(0, 0, min(kRun, S));
  for (int n = 0; n < n_runs; ++n) {
    const int t0 = n * kRun, steps = min(kRun, S - t0), buf = n & 1;
    // run n + 1 goes into the buffer that run n - 1 used; every thread has
    // passed the barrier after run n - 1's recurrence
    if (n + 1 < n_runs)
      stage(buf ^ 1, t0 + kRun, min(kRun, S - t0 - kRun));
    else
      asm volatile("cp.async.commit_group;\n" ::);   // keep one group per run
    asm volatile("cp.async.wait_group 1;\n" ::);     // run n has landed
    __syncthreads();
    const float(*sr)[D] = sm.in[buf][0];
    const float(*sk)[D] = sm.in[buf][1];
    const float(*sw)[D] = sm.in[buf][2];
    const float(*sv)[D] = sm.in[buf][3];
    // bonus scalar of each step: sum_i r[i] u[i] k[i], one warp a step
    for (int s = warp; s < steps; s += kThreads / 32) {
      float p = 0.f;
      for (int i = lane; i < D; i += 32) p = fmaf(sr[s][i] * sm.u[i], sk[s][i], p);
#pragma unroll
      for (int o = 16; o > 0; o /= 2) p += __shfl_xor_sync(0xffffffffu, p, o);
      if (lane == 0) sm.bonus[s] = p;
    }
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
      const float4 v4 = *reinterpret_cast<const float4*>(&sv[s][col0]);
      const float vj[kCols] = {v4.x, v4.y, v4.z, v4.w};
      const float b0 = q == 0 ? sm.bonus[s] : 0.f;   // added once per column
      float acc[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[j] = b0 * vj[j];
#pragma unroll
      for (int m = 0; m < kGroups; ++m) {
        const float4 r4 = *reinterpret_cast<const float4*>(&sr[s][16 * m + 4 * q]);
        const float4 k4 = *reinterpret_cast<const float4*>(&sk[s][16 * m + 4 * q]);
        const float4 w4 = *reinterpret_cast<const float4*>(&sw[s][16 * m + 4 * q]);
        const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            acc[j] = fmaf(rv[c], st[m][c][j], acc[j]);
            st[m][c][j] = fmaf(wv[c], st[m][c][j], kv[c] * vj[j]);
          }
      }
      // sum over the four lanes, transposed: lanes q and q ^ 2 trade the
      // column pair the other keeps, then q and q ^ 1 trade one column
      const bool hi = q & 2, odd = q & 1;
      float a0 = hi ? acc[2] : acc[0], a1 = hi ? acc[3] : acc[1];
      a0 += __shfl_xor_sync(0xffffffffu, hi ? acc[0] : acc[2], 2);
      a1 += __shfl_xor_sync(0xffffffffu, hi ? acc[1] : acc[3], 2);
      const float a = (odd ? a1 : a0) + __shfl_xor_sync(0xffffffffu, odd ? a0 : a1, 1);
      sm.out[s][col0 + q] = a;                     // lane q holds column col0 + q
    }
    __syncthreads();
    for (int f = tid; f < steps * kVec; f += kThreads) {
      const int s = f / kVec, c4 = (f % kVec) * 4;
      *reinterpret_cast<float4*>(orow + (long long)(t0 + s) * D + c4) =
          *reinterpret_cast<const float4*>(&sm.out[s][c4]);
    }
  }
}

Strides strides_of(const long long* s) { return Strides{s[0], s[1], s[2]}; }

}  // namespace

extern "C" {

// r, k, v, w: (B, H, S, d) float32 with strides {b, h, s} (in elements) in
// rs, ks, vs, ws, d contiguous, every row 16-byte aligned; u: (H, d) and
// out: (B, H, S, d) float32, contiguous.  d is 32 or 64.  Launches on
// `stream` and does not synchronise.
int rwkv6_wkv(const void* r, const void* k, const void* v, const void* w,
              const void* u, void* out, int B, int H, int S, int d,
              const long long* rs, const long long* ks, const long long* vs,
              const long long* ws, void* stream) {
  if (B < 0 || H < 0 || S < 0) return (int)cudaErrorInvalidValue;
  if (d != 32 && d != 64) return (int)cudaErrorInvalidValue;
  if ((long long)B * H > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* rf = static_cast<const float*>(r);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  float* of = static_cast<float*>(out);
  const dim3 grid(B * H);
  if (d == 64)
    rwkv6_wkv_kernel<64><<<grid, 64, 0, st>>>(rf, kf, vf, wf, uf, of, H, S, strides_of(rs),
                                              strides_of(ks), strides_of(vs), strides_of(ws));
  else
    rwkv6_wkv_kernel<32><<<grid, 32, 0, st>>>(rf, kf, vf, wf, uf, of, H, S, strides_of(rs),
                                              strides_of(ks), strides_of(vs), strides_of(ws));
  return (int)cudaGetLastError();
}

const char* rwkv6_wkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
