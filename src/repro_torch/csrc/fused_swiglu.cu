// Fused SwiGLU MLP: out = act(x Wg) * (x Wu) @ Wd, act in {silu, gelu_tanh}.
//
// Replaces: src/repro/kernels/fused_swiglu.py `_swiglu_kernel` /
// `fused_swiglu` (Pallas, TPU); in the model it stands in for the gated case
// of src/repro/models/mlp.py `mlp`.
//
// Two launches through an f32 h, as the TPU kernel's (bm x D) f32
// accumulator carried across the F grid axis (1.5 MB at D = 3072, bm = 128)
// fits no SM, and GPU blocks carry nothing across the grid:
//   A: h = act(x Wg) * (x Wu), tiled over (rows, F); both products share the
//      x tile, so g and u never reach memory; h (T x F, f32) does.
//   B: out = h Wd, tiled over (rows, D), summing over F.
// h costs T * F * 4 bytes written and read once (256 KB at decode, 134 MB
// at the phi3 prefill, ~0.08 ms).  Every output is summed in a fixed order
// (no atomics), so results are deterministic.  Any T, D and F: ragged edges
// are masked; when a row stride or a base address is not 16-byte aligned
// (D = 130 or F = 202 in fp32, say) the tiles are staged element by element
// instead of with 16-byte copies (a dispatch by shape, same kernels).
//
// Bounds on an H100 SXM at 700 W (495 TFLOP/s TF32, so 165 TFLOP/s of
// 3xTF32 products, and 3.35 TB/s): 6 T D F flops of products, three TF32
// passes each on fp32 data, or the weights read once.  phi3 (D 3072, F
// 8192): T = 4096 3.75 ms, T = 512 0.47 ms, T = 8 0.090 ms (bytes).  Jamba
// (D 8192, F 24576): T = 2048 15.0 ms, T = 8 0.721 ms (bytes).
//
// Large T (T > 16: prefill, training) is bound by operations and runs on
// the tensor cores through wgmma with 3xTF32: each fp32 operand v splits
// into TF32 parts hi = tf32(v) and lo = tf32(v - hi), and each product sums
// lo*hi + hi*lo + hi*hi in fp32 (lo*lo, ~2^-22 relative, is dropped).  One
// TF32 pass keeps ~3 digits and is never taken on fp32 data
// (tests/test_torch_swiglu_split.py shows both on the CPU); a bf16 value is
// exact in TF32, so its lo part is 0 and its passes are skipped.  A block
// owns a 128-row tile and 128 columns of the B operand (kernel A: 64 of Wg
// beside 64 of Wu, so one wgmma m64n128k8 computes g and u together; kernel
// B: 128 of Wd), in 32-deep K slices, and is warp specialized: warpgroups
// 0-1 (256 threads, 40 registers) load and lay out, warpgroups 2-3 (216
// registers) multiply 64 rows each, handing slices over through named
// barriers.
//   * The layout: wgmma takes TF32 operands K-major only (the transpose
//     flag exists for 16-bit types), and the weights are (K, N) row-major,
//     N-major for the B operand; TMA cannot transpose, and a transposed copy
//     of the weights would not fit beside training's 67.6 GB.  So the
//     loading warps lay B out themselves: the slice arrives by cp.async in
//     its (k, n) rows, and each thread splits 4 k of one n and writes hi and
//     lo as 16-byte runs into the K-major 8 x 4 core matrices of wgmma's
//     layout without swizzle (conflict-free stores).  A (x, or h) is
//     already K-major: each multiplying warp takes its 16 rows with ldmatrix
//     and splits them in registers (wgmma's A from registers).
//   * Pipeline: slices are loaded two ahead of the one being laid out (a
//     ring of 4 A slices, 3 B slices as loaded, 2 laid out); a slice's 12
//     wgmmas run while the multiplying warps take the next slice's A.
//   * Long sums: the tensor core truncates its fp32 sums, which over the
//     256-768 slices of d_ff would bias the output of a one-sign sum past
//     1e-4.  So each slice is summed from zero into its own registers and
//     then added to the accumulator in fp32 (round to nearest): 64 + 64
//     registers a thread, which caps the tile at 128 x 128.
//   * Blocks run grouped by 8 row tiles, so a weight column panel is reused
//     from L2 by 8 row tiles in a row.
//
// Small T (T <= 16: decode) is bound by the weight bytes.  A block of 256
// threads owns 32 output columns; each lane moves 16 bytes (4 fp32 columns
// of a weight row, 8 lanes a 128-byte row segment; 8 bytes for bf16), 64
// weight rows a stage, through a 4-stage cp.async ring (24-48 KB in flight
// a block, several blocks an SM).  The 32 row groups' partial sums meet by
// shuffles and then through shared memory, in a fixed order.  Kernel A has
// F / 32 column blocks (256 at phi3, 768 at Jamba), enough for the 132 SMs.
// Kernel B has only D / 32 (96 at phi3: a third of the SMs would read
// nothing), so it splits F across the blocks of a thread block cluster (up
// to 8, enough blocks to fill the SMs four times over); each block leaves
// its partial in shared memory and, after a cluster barrier, each block
// sums a share of the outputs over the cluster's blocks in rank order
// through distributed shared memory: no scratch in device memory, no
// atomics.
//
// Measured (chip_smoke.py phases 3 and 3d, NVIDIA H100 80GB HBM3 at 700 W),
// against the cuBLAS route (three fp32 products and the activation): phi3
// T = 4096 8.88 ms (12.29), T = 512 1.27 ms (1.58), T = 8 0.129 ms (0.262);
// Jamba T = 2048 34.6 ms (48.1), T = 8 0.846 ms (1.14).
//
// What holds it back: at large T the loads (32 KB of L2 reads a slice for
// a 128 x 128 tile) do not overlap the wgmmas fully; a larger tile would
// cut them but needs the registers that the separate per-slice sums take.
// Kernel B is not split at large T: at T = 512 its 96 tiles leave 36 SMs
// idle, yet a cluster split of F in four (as at decode) measured no
// faster.  h makes a round trip through memory.  At decode, the ring's
// fill and the cluster's reduction are a fixed cost beside the ~30 us that
// phi3's down product streams.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include <algorithm>

namespace {

namespace cg = cooperative_groups;

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

// ---- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies BYTES (8 or 16) from global to shared memory asynchronously;
// copies nothing and zero-fills when !in (src must still be a valid address).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool in) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(in ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(in ? BYTES : 0));
  }
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 matrices of 16-bit elements from shared memory, lane 8q + r
// giving the address of row r of matrix q; 32-bit elements read as pairs:
// r[q] = element (lane / 4, lane % 4) of the 8 x 4 fp32 matrix q.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// wgmma (warpgroup: 4 warps, 128 threads) D (64x128, fp32) = A (64x8) * B
// (8x128) [+ D when scale_d], TF32.  A from registers: warp w of the group
// holds rows 16w..16w+15 as mma.sync's m16n8k8 A fragment.  B from shared
// memory through the descriptor, K-major.  D: d[4 i + e] is row 16w + g +
// 8 (e / 2), column 8 i + 2 t + e % 2 (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void wgmma_tf32_m64n128k8(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps a register's value in place across an asynchronous wgmma that reads
// or writes it (the compiler sees a use and a redefinition here)
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_reg(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// wgmma shared-memory descriptor of a K-major operand without swizzle:
// 8-row x 16-byte core matrices, lbo bytes apart along K and sbo bytes apart
// along M/N
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// named barriers: bar_sync waits until `count` threads have arrived at
// barrier `id` (itself included); bar_arrive arrives without waiting
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// a warpgroup's registers per thread, lowered or raised (warp specialization)
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- 3xTF32 -----------------------------------------------------------------

// fp32 -> TF32 as a 32-bit pattern, round to nearest with ties away from
// zero, as cvt.rna.tf32.f32 rounds, in two integer operations (inf and nan
// stay inf and nan)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// hi/lo TF32 parts of an operand value; a bf16 value is exact in TF32 (lo 0)
template <typename T>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (sizeof(T) == 4) {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

// Stages a ROWS x COLS tile of a row-major matrix (leading dimension ld)
// into shared memory (row stride SST elements), from row row0 and column
// col0, zero outside nrows x ncols.  vec: 16-byte copies (ld, col0 and the
// base 16-byte aligned, ncols a multiple of the chunk) with cp.async; else
// element by element, synchronously.
template <typename T, int ROWS, int COLS, int SST, int NT>
__device__ __forceinline__ void stage_tile(T* s, const T* g, long long ld, int row0,
                                          int col0, int nrows, int ncols, bool vec) {
  constexpr int V = 16 / sizeof(T), CPR = COLS / V;
  static_assert(COLS % V == 0, "tile width must be whole 16-byte chunks");
#pragma unroll
  for (int c = threadIdx.x; c < ROWS * CPR; c += NT) {
    const int r = c / CPR, cc = (c % CPR) * V;
    const int gr = row0 + r, gc = col0 + cc;
    T* dst = s + r * SST + cc;
    if (vec) {
      const bool in = gr < nrows && gc < ncols;
      cp_async<16>(dst, in ? g + gr * ld + gc : g, in);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        dst[e] = (gr < nrows && gc + e < ncols) ? g[gr * ld + gc + e] : from_f<T>(0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// Large T on wgmma: C (M x N) = A (M x K) @ B0 (K x N), 3xTF32; gated modes:
// act(A @ B0) * (A @ B1).  All row-major and contiguous.
// ---------------------------------------------------------------------------

constexpr int BM = 128, BK = 32, kGroupM = 8;
// warpgroups 0 and 1 load K slices (cp.async) and lay out B; warpgroups 2
// and 3 multiply rows 0-63 and 64-127 of the tile
constexpr int kLoadThreads = 256, kWgThreads = 512;
constexpr int kWgBN = 128;   // B columns a block: 64 of B0 and 64 of B1 when gated
// rings: A slices as loaded (read by the multiplying warps), B slices as
// loaded (read by the layout), B laid out for wgmma (hi and lo, K-major)
constexpr int kAhead = 2;   // slices loaded ahead of the one being laid out
constexpr int kARing = kAhead + 2, kRRing = kAhead + 1, kBtRing = 2;
// named barriers (0 is __syncthreads): slice kt laid out (kFull + kt % 2),
// slice kt's wgmma done (kEmpty + kt % 2), and the loading warpgroups' own
constexpr int kFull = 1, kEmpty = 3, kLoaders = 5;

template <typename TA, typename TB>
struct WgTile {
  static constexpr int SA = BK + 16 / sizeof(TA);   // A row stride, elements
  static constexpr int A_BYTES = (BM * SA * (int)sizeof(TA) + 1023) / 1024 * 1024;
  static constexpr int R_BYTES = BK * kWgBN * sizeof(TB);   // B as loaded, (k, n) rows
  static constexpr int BT_BYTES = kWgBN * BK * 4;           // B hi or lo, TF32, K-major
  static constexpr int R_OFF = kARing * A_BYTES, BT_OFF = R_OFF + kRRing * R_BYTES;
  static constexpr int SMEM = BT_OFF + kBtRing * 2 * BT_BYTES;
};

template <typename TA, typename TB, typename TC, int MODE>
__global__ void __launch_bounds__(kWgThreads, 1)
wgmma_gemm_kernel(const TA* __restrict__ A, const TB* __restrict__ B0,
                  const TB* __restrict__ B1, TC* __restrict__ C, int M, int N, int K,
                  int vec) {
  using Tl = WgTile<TA, TB>;
  constexpr bool kGated = MODE != kPlain;
  constexpr bool kLoA = sizeof(TA) == 4, kLoB = sizeof(TB) == 4;
  constexpr int BN_OUT = kGated ? kWgBN / 2 : kWgBN;   // output columns a block
  constexpr int SA = Tl::SA, kAll = kWgThreads, kGroup = kLoadThreads;
  extern __shared__ __align__(1024) unsigned char smem[];

  // grouped tile order: kGroupM row tiles run in a row on one column panel
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN_OUT - 1) / BN_OUT;
  const int per_group = kGroupM * tiles_n, group = blockIdx.x / per_group;
  const int first_m = group * kGroupM, gsize = min(tiles_m - first_m, kGroupM);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % gsize) * BM, n0 = (in_group / gsize) * BN_OUT;
  const int nk = (K + BK - 1) / BK;

  auto As = [&](int kt) { return reinterpret_cast<TA*>(smem + kt % kARing * Tl::A_BYTES); };
  auto Rs = [&](int kt) {
    return reinterpret_cast<TB*>(smem + Tl::R_OFF + kt % kRRing * Tl::R_BYTES);
  };
  auto Bh = [&](int kt) {
    return reinterpret_cast<float*>(smem + Tl::BT_OFF + kt % kBtRing * 2 * Tl::BT_BYTES);
  };
  auto Bl = [&](int kt) { return Bh(kt) + kWgBN * BK; };

  if (threadIdx.x < kGroup) {
    // ---- loading warpgroups: slice i is loaded at step i and laid out at
    // step i + kAhead, once the wgmma of slice i - 2 has freed its places
    setmaxnreg_dec<40>();
    auto load = [&](int kt) {
      const int k0 = kt * BK;
      stage_tile<TA, BM, BK, SA, kGroup>(As(kt), A, K, m0, k0, M, K, vec);
      if constexpr (kGated) {
        stage_tile<TB, BK, kWgBN / 2, kWgBN, kGroup>(Rs(kt), B0, N, k0, n0, K, N, vec);
        stage_tile<TB, BK, kWgBN / 2, kWgBN, kGroup>(Rs(kt) + kWgBN / 2, B1, N, k0, n0, K,
                                                     N, vec);
      } else {
        stage_tile<TB, BK, kWgBN, kWgBN, kGroup>(Rs(kt), B0, N, k0, n0, K, N, vec);
      }
    };
    // B as loaded, (k, n) -> its TF32 hi and lo parts in wgmma's K-major
    // layout without swizzle: 8 x 4 core matrices (8 n, 4 k; 128 bytes),
    // element (n, k) at float ((n / 8) * (BK / 4) + k / 4) * 32 + (n % 8) * 4
    // + k % 4, so core matrices are 128 bytes apart along K and 1024 along
    // N.  A thread takes 4 k of one n: one 16-byte store each for hi and lo.
    auto lay_out = [&](int kt) {
      const TB* R = Rs(kt);
      float* H = Bh(kt);
      float* L = Bl(kt);
#pragma unroll
      for (int it = 0; it < kWgBN * BK / 4 / kGroup; ++it) {
        const int item = threadIdx.x + it * kGroup;
        const int n = item % kWgBN, kc = item / kWgBN;
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) split<TB>(to_f(R[(4 * kc + r) * kWgBN + n]), hi[r], lo[r]);
        const int off = ((n / 8) * (BK / 4) + kc) * 32 + (n % 8) * 4;
        *reinterpret_cast<uint4*>(H + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        if constexpr (kLoB)
          *reinterpret_cast<uint4*>(L + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    };
    for (int i = 0; i < nk + kAhead; ++i) {
      // slice i - kAhead - 2 done: its A and laid-out B places are free
      if (i >= kAhead + 2) bar_sync(kEmpty + (i - kAhead) % 2, kAll);
      if (i < nk) load(i);
      cp_commit();
      if (i >= kAhead) {
        cp_wait<kAhead>();                            // slice i - kAhead landed
        bar_sync(kLoaders, kGroup);
        lay_out(i - kAhead);
        fence_proxy_async();
        bar_arrive(kFull + (i - kAhead) % 2, kAll);
        bar_sync(kLoaders, kGroup);                   // its B rows free for slice i + 1
      }
    }
    cp_wait<0>();
    return;
  }

  // ---- multiplying warpgroups
  setmaxnreg_inc<216>();
  const int warp = (threadIdx.x - kLoadThreads) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int arow = 16 * warp;   // this warp's 16 rows of the tile

  // this warp's A fragments for the slice's four 8-deep steps, split
  auto a_frags = [&](int kt, uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
    const TA* a = As(kt);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if constexpr (kLoA) {
        // lanes 0-15: rows 0-15 at column 8 u; lanes 16-31: at 8 u + 4
        uint32_t r[4];
        ldmatrix_x4(r, a + (arow + lane % 16) * SA + 8 * u + (lane / 16) * 4);
#pragma unroll
        for (int q = 0; q < 4; ++q) split<TA>(__uint_as_float(r[q]), ah[u][q], al[u][q]);
      } else {
        const TA* p = a + (arow + g) * SA + 8 * u + t;
        split<TA>(to_f(p[0]), ah[u][0], al[u][0]);
        split<TA>(to_f(p[8 * SA]), ah[u][1], al[u][1]);
        split<TA>(to_f(p[4]), ah[u][2], al[u][2]);
        split<TA>(to_f(p[8 * SA + 4]), ah[u][3], al[u][3]);
      }
    }
  };
  // the slice's products into tmp, summed by the tensor core from zero:
  // lo*hi, hi*lo, hi*hi for each 8-deep step (a bf16 operand's pass skipped)
  float tmp[64];
  auto multiply = [&](int kt, uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
    const float* H = Bh(kt);
    const float* L = Bl(kt);
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_reg(tmp[i]);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint64_t dh = wgmma_desc(H + 64 * u, 128, 1024);
      const uint64_t dl = wgmma_desc(L + 64 * u, 128, 1024);
      if constexpr (kLoA) wgmma_tf32_m64n128k8(tmp, al[u], dh, u > 0);
      if constexpr (kLoB) wgmma_tf32_m64n128k8(tmp, ah[u], dl, kLoA || u > 0);
      wgmma_tf32_m64n128k8(tmp, ah[u], dh, kLoA || kLoB || u > 0);
    }
    wgmma_commit();
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  uint32_t ah0[4][4], al0[4][4], ah1[4][4], al1[4][4];
  bar_sync(kFull, kAll);
  a_frags(0, ah0, al0);

  // Slice kt's products run on the tensor cores while the warps take the
  // next slice's A fragments; then the slice's sums are added to acc in fp32.
  auto step = [&](int kt, uint32_t (&ah)[4][4], uint32_t (&al)[4][4],
                  uint32_t (&ah_next)[4][4], uint32_t (&al_next)[4][4]) {
    multiply(kt, ah, al);
    if (kt + 1 < nk) {
      bar_sync(kFull + (kt + 1) % 2, kAll);
      a_frags(kt + 1, ah_next, al_next);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_reg(tmp[i]);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        fence_reg(ah[u][q]);
        fence_reg(al[u][q]);
      }
    if (kt + 2 < nk) bar_arrive(kEmpty + kt % 2, kAll);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += tmp[i];
  };
  for (int kt = 0; kt < nk; kt += 2) {
    step(kt, ah0, al0, ah1, al1);
    if (kt + 1 < nk) step(kt + 1, ah1, al1, ah0, al0);
  }

  // acc[4 i + e]: row arow + g + 8 (e / 2), B column 8 i + 2 t + e % 2; gated,
  // column c of the output reads g at B column c and u at 64 + c
#pragma unroll
  for (int i = 0; i < BN_OUT / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + arow + g + 8 * (e / 2), c = n0 + 8 * i + 2 * t + e % 2;
      if (r >= M || c >= N) continue;
      const float val = kGated ? epilogue<MODE>(acc[4 * i + e], acc[4 * (i + 8) + e])
                               : acc[4 * i + e];
      C[(long long)r * N + c] = from_f<TC>(val);
    }
}

// ---------------------------------------------------------------------------
// Small T (M <= 16 rows): C = A @ B0 (or act(A @ B0) * (A @ B1)), streaming
// the weights.  Launched as clusters of gridDim.y blocks along y: block y
// sums K rows [y * k_per_split, (y + 1) * k_per_split), and with more than
// one the cluster adds its partials in rank order (plain mode only).
// ---------------------------------------------------------------------------

constexpr int kSkM = 16, kSkThreads = 256, kSkCols = 32, kSkKC = 64, kSkStages = 4;
constexpr int kSkQuads = kSkCols / 4;                 // 8 lanes a weight row
constexpr int kSkRowGroups = kSkThreads / kSkQuads;   // 32 rows in flight a pass
constexpr int kSkWarps = kSkThreads / 32;
constexpr int kMaxSplits = 8;                         // portable cluster size

template <typename TA, typename TB, int MODE, int MT>
struct SkinnyTile {
  static constexpr int NB = MODE == kPlain ? 1 : 2;
  static constexpr int SA = kSkKC + 16 / sizeof(TA);
  static constexpr int A_BYTES = MT * SA * sizeof(TA);
  static constexpr int B_ELEMS = kSkKC * kSkCols;
  static constexpr int STAGE_BYTES = A_BYTES + NB * B_ELEMS * sizeof(TB);
  // the warps' sums, then the block's partial for the cluster
  static constexpr int RED_BYTES = NB * kSkWarps * MT * kSkCols * 4;
  static constexpr int PART_BYTES = MT * kSkCols * 4;
  static constexpr int SMEM = kSkStages * STAGE_BYTES > RED_BYTES + PART_BYTES
                                  ? kSkStages * STAGE_BYTES
                                  : RED_BYTES + PART_BYTES;
};

template <typename TA, typename TB, typename TC, int MODE, int MT>
__global__ void __launch_bounds__(kSkThreads)
skinny_kernel(const TA* __restrict__ A, const TB* __restrict__ B0,
              const TB* __restrict__ B1, TC* __restrict__ C, int M, int N, int K,
              int k_per_split, int vec) {
  using Tl = SkinnyTile<TA, TB, MODE, MT>;
  constexpr int NB = Tl::NB, SA = Tl::SA;
  constexpr int CB = 4 * sizeof(TB);                  // bytes of 4 weight columns
  extern __shared__ __align__(1024) unsigned char smem[];

  const int n0 = blockIdx.x * kSkCols;
  const int k_lo = blockIdx.y * k_per_split, k_hi = min(K, k_lo + k_per_split);
  const int nk = (k_hi - k_lo + kSkKC - 1) / kSkKC;
  const int quad = threadIdx.x % kSkQuads, rg = threadIdx.x / kSkQuads;

  auto a_stage = [&](int s) { return reinterpret_cast<TA*>(smem + s * Tl::STAGE_BYTES); };
  auto b_stage = [&](int s, int nb) {
    return reinterpret_cast<TB*>(smem + s * Tl::STAGE_BYTES + Tl::A_BYTES) + nb * Tl::B_ELEMS;
  };
  auto load = [&](int s, int kt) {
    const int k0 = k_lo + kt * kSkKC;
    stage_tile<TA, MT, kSkKC, SA, kSkThreads>(a_stage(s), A, K, 0, k0, M, k_hi, vec);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const TB* B = nb == 0 ? B0 : B1;
      TB* Bs = b_stage(s, nb);
#pragma unroll
      for (int c = threadIdx.x; c < kSkKC * kSkQuads; c += kSkThreads) {
        const int r = c / kSkQuads, cc = (c % kSkQuads) * 4;
        const int gk = k0 + r, gn = n0 + cc;
        TB* dst = Bs + r * kSkCols + cc;
        if (vec) {
          const bool in = gk < k_hi && gn < N;
          cp_async<CB>(dst, in ? B + (long long)gk * N + gn : B, in);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dst[e] = (gk < k_hi && gn + e < N) ? B[(long long)gk * N + gn + e]
                                               : from_f<TB>(0.f);
        }
      }
    }
  };

  float acc[NB][MT][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][m][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kSkStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<kSkStages - 2>();
    __syncthreads();
    if (kt + kSkStages - 1 < nk) load((kt + kSkStages - 1) % kSkStages, kt + kSkStages - 1);
    cp_commit();
    const TA* As = a_stage(kt % kSkStages);
#pragma unroll
    for (int rr = 0; rr < kSkKC / kSkRowGroups; ++rr) {
      const int r = rg + rr * kSkRowGroups;
      float b[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const TB* src = b_stage(kt % kSkStages, nb) + r * kSkCols + quad * 4;
        if constexpr (sizeof(TB) == 4) {
          const float4 w = *reinterpret_cast<const float4*>(src);
          b[nb][0] = w.x; b[nb][1] = w.y; b[nb][2] = w.z; b[nb][3] = w.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) b[nb][e] = to_f(src[e]);
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float a = to_f(As[m * SA + r]);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nb][m][e] += a * b[nb][e];
      }
    }
  }
  cp_wait<0>();

  // the warp's 4 row groups (lanes 8 apart), then the 8 warps in order
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = acc[nb][m][e];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        acc[nb][m][e] = v;
      }
  __syncthreads();                                    // the ring is reused for the sums
  float* red = reinterpret_cast<float*>(smem);        // [nb][warp][m][col]
  float* part = red + NB * kSkWarps * MT * kSkCols;   // [m][col], split launches only
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < kSkQuads) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[((nb * kSkWarps + warp) * MT + m) * kSkCols + lane * 4 + e] = acc[nb][m][e];
  }
  __syncthreads();
  const int splits = gridDim.y;
  for (int o = threadIdx.x; o < MT * kSkCols; o += kSkThreads) {
    const int m = o / kSkCols, c = o % kSkCols, gn = n0 + c;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int w = 0; w < kSkWarps; ++w) {
      s0 += red[(w * MT + m) * kSkCols + c];
      if constexpr (NB == 2) s1 += red[((kSkWarps + w) * MT + m) * kSkCols + c];
    }
    if (MODE == kPlain && splits > 1) part[o] = s0;
    else if (m < M && gn < N) C[(long long)m * N + gn] = from_f<TC>(epilogue<MODE>(s0, s1));
  }
  if constexpr (MODE == kPlain) {
    if (splits > 1) {
      // each block of the cluster sums a share of the outputs over the
      // cluster's partials, in rank order (block rank == blockIdx.y)
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      constexpr int kOut = MT * kSkCols;
      const int per = (kOut + splits - 1) / splits, rank = (int)cluster.block_rank();
      const int o_end = min(kOut, (rank + 1) * per);
      for (int o = rank * per + threadIdx.x; o < o_end; o += kSkThreads) {
        const int m = o / kSkCols, gn = n0 + o % kSkCols;
        float s = 0.f;
        for (int p = 0; p < splits; ++p) s += cluster.map_shared_rank(part, p)[o];
        if (m < M && gn < N) C[(long long)m * N + gn] = from_f<TC>(s);
      }
      cluster.sync();                                 // no block leaves while read
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

int sm_count() {
  int dev = 0, n = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// K splits of the decode down product h (T x F) @ Wd (F x D), the blocks
// of a split being one cluster: enough blocks to fill the SMs four times
// over, each split at least 4 stages of K deep, at most a portable cluster
int down_splits(int D, int F) {
  const int blocks = (D + kSkCols - 1) / kSkCols;
  const int want = (4 * sm_count() + blocks - 1) / blocks;
  return std::max(1, std::min({want, kMaxSplits, F / (4 * kSkKC)}));
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename TA, typename TB, typename TC, int MODE>
int wg_gemm(const void* A, const void* B0, const void* B1, void* C, int M, int N, int K,
            bool vec, cudaStream_t st) {
  using Tl = WgTile<TA, TB>;
  auto kernel = wgmma_gemm_kernel<TA, TB, TC, MODE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tl::SMEM);
  if (err != cudaSuccess) return (int)err;
  constexpr int BN_OUT = MODE == kPlain ? kWgBN : kWgBN / 2;
  const int grid = ((M + BM - 1) / BM) * ((N + BN_OUT - 1) / BN_OUT);
  kernel<<<grid, kWgThreads, Tl::SMEM, st>>>(
      static_cast<const TA*>(A), static_cast<const TB*>(B0), static_cast<const TB*>(B1),
      static_cast<TC*>(C), M, N, K, (int)vec);
  return (int)cudaGetLastError();
}

// Launches the skinny kernel on the column blocks x the K splits (whole
// stages) that hold any rows, as clusters of those splits
template <typename TA, typename TB, typename TC, int MODE>
int skinny(const void* A, const void* B0, const void* B1, void* C, int M, int N, int K,
           int splits, bool vec, cudaStream_t st) {
  const int depth = ((K + splits - 1) / splits + kSkKC - 1) / kSkKC * kSkKC;
  const unsigned used = (K + depth - 1) / depth;
  auto go = [&](auto kernel, int smem) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((N + kSkCols - 1) / kSkCols, used);
    cfg.blockDim = dim3(kSkThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = 1;
    cluster.val.clusterDim.y = used;
    cluster.val.clusterDim.z = 1;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const TA*>(A),
                             static_cast<const TB*>(B0), static_cast<const TB*>(B1),
                             static_cast<TC*>(C), M, N, K, depth, (int)vec);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  };
  if (M <= 8) return go(skinny_kernel<TA, TB, TC, MODE, 8>, SkinnyTile<TA, TB, MODE, 8>::SMEM);
  return go(skinny_kernel<TA, TB, TC, MODE, kSkM>, SkinnyTile<TA, TB, MODE, kSkM>::SMEM);
}

template <typename T>
int dispatch(int act, const void* x, const void* wg, const void* wu, const void* wd,
             float* h, void* out, int T_, int D, int F, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  // 16-byte staging needs 16-byte aligned rows of x, the weights and h
  const bool vec = D % V == 0 && F % V == 0 && aligned16(x) && aligned16(wg) &&
                   aligned16(wu) && aligned16(wd) && aligned16(h);
  int err;
  if (T_ <= kSkM) {
    err = act == 0 ? skinny<T, T, float, kSilu>(x, wg, wu, h, T_, F, D, 1, vec, st)
                   : skinny<T, T, float, kGeluTanh>(x, wg, wu, h, T_, F, D, 1, vec, st);
    if (err) return err;
    return skinny<float, T, T, kPlain>(h, wd, nullptr, out, T_, D, F, down_splits(D, F), vec,
                                       st);
  }
  err = act == 0 ? wg_gemm<T, T, float, kSilu>(x, wg, wu, h, T_, F, D, vec, st)
                 : wg_gemm<T, T, float, kGeluTanh>(x, wg, wu, h, T_, F, D, vec, st);
  if (err) return err;
  return wg_gemm<float, T, T, kPlain>(h, wd, nullptr, out, T_, D, F, vec, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; act: 0 = silu, 1 = gelu_tanh.
// x: (T, D), wg/wu: (D, F), wd: (F, D), out: (T, D), all contiguous.
// h: (T, F) float32 scratch allocated by the caller.
int fused_swiglu(int dtype, int act, const void* x, const void* wg, const void* wu,
                 const void* wd, float* h, void* out, int T_, int D, int F, void* stream) {
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
