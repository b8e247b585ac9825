// Mamba selective scan (S6), serial in time, from h = 0.
//
// Replaces: src/repro/kernels/mamba_scan.py `_scan_kernel` / `mamba_scan`
// (Pallas, TPU).  For each batch row r and channel j < d:
//   h_t[n] = exp(dt_t[j] * a[j, n]) * h_{t-1}[n] + (dt_t[j] * x_t[j]) * b_t[n]
//   y_t[j] = sum_n h_t[n] * c_t[n]
// with dt, x, y (B, S, d), b, c (B, S, N), a (d, N) = -exp(A_log), all
// float32 and contiguous; N is 8 or 16.  The D * x skip and the gate stay
// outside the kernel, as in repro.
//
// Bound on the card, at the prefill shape of the served Jamba period
// (B 2, S 1024, d 16384, N 16):
//   special-function unit: one exponential per (t, j, n) = 537 M, >= 0.128 ms
//     at 132 SMs x 16 per clock (1.98 GHz).  This sets the bound;
//   bytes: read dt and x, write y: 3 * 4 * B * S * d = 403 MB (b, c and a add
//     0.3 MB), >= 0.120 ms at 3.35 TB/s;
//   fp32: ~6 flops per (t, j, n) = 3.2 GFLOP, >= 0.048 ms at 67 TFLOP/s.
// The two bounds lie within 7% of each other, so the kernel has to keep the
// SFU and the memory busy at once.
//
// Design.  The TPU kernel walks a (batch, chunk) grid in order and carries
// the (d, N) state in VMEM from one grid step to the next.  Blocks on Hopper
// run in no order and carry nothing, so a block owns channels of one batch
// row for the whole sequence and keeps their states in registers.
//   * A channel's N states are split across L = N / 4 lanes, four states a
//     lane (L = 4 at N = 16, L = 2 at N = 8), and a lane owns the same four
//     states of kCh = 2 neighbouring channels.  A block of 128 threads owns
//     64 channels at N = 16 (128 at N = 8).  At the Jamba shape that is
//     65,536 threads, 512 blocks, 4 blocks (16 warps) on most SMs; ptxas
//     gives 84-96 registers and no spills.  Each step a lane reads dt and x of
//     its channels and b and c of its states from shared memory; with two
//     channels those reads serve 8 (t, j, n) instead of 4.  One channel a
//     lane (twice the threads, 32 warps an SM) measured slower
//     (chip_mamba_scan_ablation.py, "one channel a lane"); L = 8 (two states
//     a lane) would halve what each read serves again.
//   * One SFU op per exponential: exp(dt a) = ex2.approx.ftz(dt * (a log2 e)),
//     a log2 e formed once when a thread loads its a.  That is one FMUL and
//     one MUFU.EX2 per (t, j, n) where expf took ~6 FP32 instructions around
//     its MUFU.EX2; with the update (FMUL dtx b, FFMA h e + .) and the
//     readout (FFMA), 4 FP32 instructions a (t, j, n) remain.  ex2.approx's
//     error is ~2 ulp of the decay; with the rounding of dt * (a log2 e) the
//     decay differs from expf's by a few ulp.  Over a long memory (the
//     init's dt ~ 1e-3 at a = -1: ~1000 steps) a relative error e of the
//     decay grows to ~e / (1 - decay) of h, ~1e-4 for a 2-ulp bias;
//     tests/test_torch_mamba_split.py holds the kernel's arithmetic, with
//     every decay pushed 2 ulp up or down, to float64 at repro's 2e-4 on
//     such a draw, and chip_smoke.py phase 3c the kernel on the card.  ftz:
//     a decay below 2^-126 becomes 0, which changes h by less than
//     2^-126 |h|.
//   * Each lane sums its four states' readout by fused multiply-adds in
//     order and writes its two channels' partials to shared memory (one
//     8-byte store a step, rows padded so the lanes hit distinct banks).
//     After the tile, the y store sums a channel's L partials as
//     (p0 + p2) + (p1 + p3) (p0 + p1 at L = 2) and writes y with coalesced
//     16-byte stores.  A transposing shuffle butterfly in the recurrence
//     (lane q keeping value q) took 3 shuffles, 3 adds and 6 selects per 2
//     steps where this takes one store a step and 1.5 adds, and was slower.
//   * Every per-step input is staged ahead of the recurrence: dt, x, b and c
//     of kTile = N steps are copied into shared memory with cp.async, two
//     tiles in flight (16-byte copies; 4-byte copies where d is not a
//     multiple of 4 or a pointer is not 16-byte aligned).  Each element of
//     dt, x and y crosses HBM once; b and c are re-read from L2 by each of
//     the d / 64 blocks of a row.  Channels past d are zero-filled.
// Considered and rejected: a chunked two-pass scan (parallel in S) would
// compute every exponential twice, or their products along the chunk, and
// so double the SFU bound.
//
// What limits it now (chip_mamba_scan_ablation.py; PERF.md, PR 21): neither
// the SFU nor the memory.  Without its exponentials, loads and stores the
// kernel keeps ~80% of its time: the instruction stream itself (per step
// and warp 20 FMUL, 14 FFMA, 8 MUFU, 4 LDS, 1 STS at N = 16) at 4 warps a
// scheduler, which do not hide its latencies.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;   // threads a block
constexpr int kPer = 4;         // states a lane owns
constexpr int kCh = 2;          // channels a lane owns: they share its reads of b and c
constexpr float kLog2e = 1.4426950408889634f;

template <int N>
struct Tiles {
  static constexpr int L = N / kPer;              // lanes a channel's states are split across
  static constexpr int CH = kThreads / L * kCh;   // channels a block owns
  // time steps per staged tile, two in flight: 16 at N = 16, 8 at N = 8,
  // whose blocks own twice the channels
  static constexpr int kTile = N;
  // a row of partial readouts: a half-warp's L lanes write 32 / L floats
  // each, padded so that they hit distinct banks
  static constexpr int kPitch = CH + 32 / L;
  float dt[2][kTile][CH];
  float x[2][kTile][CH];
  float b[2][kTile][N];
  float c[2][kTile][N];
  float part[kTile][L][kPitch];                   // lane q's partial readouts of a step
};

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// cp.async of kBytes (4 or 16); a copy that is not `valid` fills zeros and
// reads nothing
template <int kBytes>
__device__ __forceinline__ void copy_async(float* smem, const float* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned n = valid ? kBytes : 0;
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}

// K consecutive floats of shared memory in one access
template <int K>
__device__ __forceinline__ void load_row(const float* p, float (&v)[K]) {
  if constexpr (K == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    static_assert(K == 1, "one or two channels a lane");
    v[0] = *p;
  }
}

template <int K>
__device__ __forceinline__ void store_row(float* p, const float (&v)[K]) {
  if constexpr (K == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *p = v[0];
}

// the sum of a channel's L partial readouts, in the order the CPU tests
// emulate: (p0 + p2) + (p1 + p3), or p0 + p1
template <int L, typename T>
__device__ __forceinline__ T lane_sum(const T (&p)[L]) {
  if constexpr (L == 4)
    return (p[0] + p[2]) + (p[1] + p[3]);
  else
    return p[0] + p[1];
}

__device__ __forceinline__ float4 operator+(float4 u, float4 v) {
  return make_float4(u.x + v.x, u.y + v.y, u.z + v.z, u.w + v.w);
}

// step s of the staged tile `buf` for the lane's kPer states h of channels
// ch0 .. ch0 + kCh - 1 (decays from a2 = a log2 e); writes the lane's
// partial readouts of its channels
template <int N>
__device__ __forceinline__ void scan_step(Tiles<N>& sm, int buf, int s, int ch0, int q,
                                          const float (&a2)[kCh][kPer],
                                          float (&h)[kCh][kPer]) {
  float dtv[kCh], xv[kCh], p[kCh];
  load_row(&sm.dt[buf][s][ch0], dtv);
  load_row(&sm.x[buf][s][ch0], xv);
  const float4 b4 = *reinterpret_cast<const float4*>(&sm.b[buf][s][kPer * q]);
  const float4 c4 = *reinterpret_cast<const float4*>(&sm.c[buf][s][kPer * q]);
  const float bv[kPer] = {b4.x, b4.y, b4.z, b4.w};
  const float cv[kPer] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
  for (int k = 0; k < kCh; ++k) {
    const float dtx = dtv[k] * xv[k];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      h[k][i] = fmaf(h[k][i], ex2(dtv[k] * a2[k][i]), dtx * bv[i]);
      p[k] = i == 0 ? h[k][i] * cv[i] : fmaf(h[k][i], cv[i], p[k]);
    }
  }
  store_row(&sm.part[s][q][ch0], p);
}

template <int N, bool kVec>
__global__ void __launch_bounds__(kThreads, 8 / kCh)
mamba_scan_kernel(const float* __restrict__ dt, const float* __restrict__ bm,
                  const float* __restrict__ cm, const float* __restrict__ x,
                  const float* __restrict__ a, float* __restrict__ y, int S, int d) {
  using Sm = Tiles<N>;
  constexpr int L = Sm::L, CH = Sm::CH, kTile = Sm::kTile;
  constexpr int kW = kVec ? 4 : 1;            // floats a copy moves
  __shared__ __align__(16) Sm sm;

  const int tid = threadIdx.x;
  const int q = tid % L;                      // the lane's states: kPer * q .. kPer * q + 3
  const int ch0 = tid / L * kCh;              // the lane's first channel in the block
  const int j0 = blockIdx.x * CH;
  const long long row = blockIdx.y;
  const float* dtrow = dt + row * S * d + j0;
  const float* xrow = x + row * S * d + j0;
  float* yrow = y + row * S * d + j0;
  const float* brow = bm + row * S * N;
  const float* crow = cm + row * S * N;

  float a2[kCh][kPer], h[kCh][kPer];
#pragma unroll
  for (int k = 0; k < kCh; ++k)
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = j0 + ch0 + k;
      a2[k][i] = j < d ? a[(long long)j * N + kPer * q + i] * kLog2e : 0.f;
      h[k][i] = 0.f;
    }

  // the tile's steps from t0 (up to kTile), channels past d zero-filled
  auto stage = [&](int buf, int t0) {
    const int rows = min(kTile, S - t0);
    constexpr int kRowCopies = CH / kW;
    for (int f = tid; f < rows * kRowCopies; f += kThreads) {
      const int s = f / kRowCopies, c = f % kRowCopies * kW;
      const bool ok = j0 + c < d;
      const long long off = ok ? (long long)(t0 + s) * d + c : 0;
      copy_async<4 * kW>(&sm.dt[buf][s][c], dtrow + off, ok);
      copy_async<4 * kW>(&sm.x[buf][s][c], xrow + off, ok);
    }
    constexpr int kStepCopies = N / kW;
    for (int f = tid; f < rows * kStepCopies; f += kThreads) {
      const int s = f / kStepCopies, n = f % kStepCopies * kW;
      const long long off = (long long)(t0 + s) * N + n;
      copy_async<4 * kW>(&sm.b[buf][s][n], brow + off, true);
      copy_async<4 * kW>(&sm.c[buf][s][n], crow + off, true);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  const int n_tiles = (S + kTile - 1) / kTile;
  stage(0, 0);
  for (int n = 0; n < n_tiles; ++n) {
    const int t0 = n * kTile, steps = min(kTile, S - t0), buf = n & 1;
    // tile n + 1 goes into the buffer that tile n - 1 used; every thread has
    // passed the barrier after tile n - 1's recurrence
    if (n + 1 < n_tiles)
      stage(buf ^ 1, t0 + kTile);
    else
      asm volatile("cp.async.commit_group;\n" ::);   // keep one group per tile
    asm volatile("cp.async.wait_group 1;\n" ::);     // tile n has landed
    __syncthreads();
    if (steps == kTile) {
#pragma unroll
      for (int s = 0; s < kTile; ++s) scan_step<N>(sm, buf, s, ch0, q, a2, h);
    } else {
      for (int s = 0; s < steps; ++s) scan_step<N>(sm, buf, s, ch0, q, a2, h);
    }
    __syncthreads();
    // y = the sum of the L lanes' partials, kW channels a thread at a time
    constexpr int kRowCopies = CH / kW;
    for (int f = tid; f < steps * kRowCopies; f += kThreads) {
      const int s = f / kRowCopies, c = f % kRowCopies * kW;
      if (j0 + c >= d) continue;
      float* dst = yrow + (long long)(t0 + s) * d + c;
      if constexpr (kVec) {
        float4 pv[L];
#pragma unroll
        for (int l = 0; l < L; ++l) pv[l] = *reinterpret_cast<const float4*>(&sm.part[s][l][c]);
        *reinterpret_cast<float4*>(dst) = lane_sum<L>(pv);
      } else {
        float pv[L];
#pragma unroll
        for (int l = 0; l < L; ++l) pv[l] = sm.part[s][l][c];
        *dst = lane_sum<L>(pv);
      }
    }
  }
}

template <int N>
void launch(bool vec, int B, int S, int d, cudaStream_t st, const float* dt, const float* b,
            const float* c, const float* x, const float* a, float* y) {
  const dim3 grid((d + Tiles<N>::CH - 1) / Tiles<N>::CH, B);
  if (vec)
    mamba_scan_kernel<N, true><<<grid, kThreads, 0, st>>>(dt, b, c, x, a, y, S, d);
  else
    mamba_scan_kernel<N, false><<<grid, kThreads, 0, st>>>(dt, b, c, x, a, y, S, d);
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

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
  const float* dtf = static_cast<const float*>(dt);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(c);
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(a);
  float* yf = static_cast<float*>(y);
  // 16-byte copies need every row of dt, x, y, b and c 16-byte aligned
  const bool vec = d % 4 == 0 && aligned16(dt) && aligned16(x) && aligned16(y) &&
                   aligned16(b) && aligned16(c);
  if (N == 8)
    launch<8>(vec, B, S, d, st, dtf, bf, cf, xf, af, yf);
  else
    launch<16>(vec, B, S, d, st, dtf, bf, cf, xf, af, yf);
  return (int)cudaGetLastError();
}

const char* mamba_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
