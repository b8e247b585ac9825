// Mamba selective scan (S6), serial in time, from h = 0.
//
// Replaces: src/repro/kernels/mamba_scan.py `_scan_kernel` / `mamba_scan`
// (Pallas, TPU).  For each batch row r and channel j < d:
//   h_t[n] = exp(dt_t[j] * a[j, n]) * h_{t-1}[n] + (dt_t[j] * x_t[j]) * b_t[n]
//   y_t[j] = sum_n h_t[n] * c_t[n]
// with dt, x, y (B, S, d), b, c (B, S, N), a (d, N) = -exp(A_log), all
// float32 and contiguous.  The D * x skip and the gate stay outside the
// kernel, as in repro.
//
// Bound on the card, at the prefill shape of the served Jamba period
// (B 2, S 1024, d 16384, N 16):
//   bytes: read dt and x, write y: 3 * 4 * B * S * d = 403 MB (b, c and a add
//     0.3 MB), >= 0.120 ms at 3.35 TB/s;
//   special-function unit: one exponential per (t, j, n) = 537 M, >= 0.13 ms
//     at 132 SMs x 16 per clock (1.98 GHz);
//   fp32: ~6 flops per (t, j, n) = 3.2 GFLOP, >= 0.048 ms at 67 TFLOP/s.
//
// Design.  The TPU kernel walks a (batch, chunk) grid in order and carries
// the (d, N) state in VMEM from one grid step to the next.  Blocks on Hopper
// run in no order and carry nothing, so here one thread owns one (batch row,
// channel) for the whole sequence and keeps its N states and its N values
// of a in registers; the kernel needs no chunking.  A block is kThreads
// consecutive channels of one batch row, so each step's loads of dt and x
// and its store of y are coalesced along d.  b_t and c_t are the same for
// every channel of the row: the block stages them for kTile steps at a time
// in shared memory (2 * kTile * N floats) and every thread reads them as
// broadcasts.  expf, not __expf (the tolerance is repro's 2e-4).
//
// What limits it: one thread per (row, channel) gives B * d = 32,768
// threads, 248 per SM, and each runs a serial chain of S steps; that is too
// few warps to hide the latency of the loads and of expf.  Splitting N
// across lanes (warp-shuffle readout) or a chunked two-pass scan would add
// parallelism; both are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // channels per block
constexpr int kTile = 64;       // time steps of b and c staged per pass

template <int N>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const float* __restrict__ dt, const float* __restrict__ bm,
                  const float* __restrict__ cm, const float* __restrict__ x,
                  const float* __restrict__ a, float* __restrict__ y, int S, int d) {
  __shared__ __align__(16) float sb[kTile * N];
  __shared__ __align__(16) float sc[kTile * N];
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const bool active = j < d;          // the ragged edge of d
  float av[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    av[n] = active ? a[(long long)j * N + n] : 0.f;
    h[n] = 0.f;
  }
  const long long row = blockIdx.y;
  const float* brow = bm + row * S * N;
  const float* crow = cm + row * S * N;
  const long long col = row * S * d + j;    // (row, 0, j) in dt, x and y
  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int steps = min(kTile, S - t0);
    __syncthreads();                  // every thread is done with the last tile
    for (int i = threadIdx.x; i < steps * N; i += kThreads) {
      sb[i] = brow[(long long)t0 * N + i];
      sc[i] = crow[(long long)t0 * N + i];
    }
    __syncthreads();
    if (!active) continue;
    const long long off = col + (long long)t0 * d;
#pragma unroll 4
    for (int s = 0; s < steps; ++s) {
      const float dtv = dt[off + (long long)s * d];
      const float dtx = dtv * x[off + (long long)s * d];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = h[n] * expf(dtv * av[n]) + dtx * sb[s * N + n];
        acc += h[n] * sc[s * N + n];
      }
      y[off + (long long)s * d] = acc;
    }
  }
}

}  // namespace

extern "C" {

// dt, x, y: (B, S, d); b, c: (B, S, N); a: (d, N); float32, contiguous.
// N is 8 or 16.  Launches on `stream` and does not synchronise.
int mamba_scan(const void* dt, const void* b, const void* c, const void* x,
               const void* a, void* y, int B, int S, int d, int N, void* stream) {
  if (B < 0 || S < 0 || d < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (N != 8 && N != 16) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || d == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((d + kThreads - 1) / kThreads, B);
  const float* dtf = static_cast<const float*>(dt);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(c);
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(a);
  float* yf = static_cast<float*>(y);
  if (N == 8)
    mamba_scan_kernel<8><<<grid, kThreads, 0, st>>>(dtf, bf, cf, xf, af, yf, S, d);
  else
    mamba_scan_kernel<16><<<grid, kThreads, 0, st>>>(dtf, bf, cf, xf, af, yf, S, d);
  return (int)cudaGetLastError();
}

const char* mamba_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
