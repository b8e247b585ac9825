// Building blocks of the tensor-core (3xTF32 wgmma) kernels: flash_attention.cu
// and flash_attention_bwd.cu include this file.  PTX wrappers for wgmma,
// named barriers and setmaxnreg; the TF32 split; staging of fp32 or bf16
// rows into wgmma's K-major operand layouts (as they lie, or transposed
// with the 8-step key permutation that makes an accumulator's registers
// A fragments); and the product of such A fragments with a staged B.
//
// The build hashes every csrc/*.cuh with each .cu (kernels/_build.py), so
// an edit here rebuilds both libraries.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides { long long b, s, h; };

// ---- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma (warpgroup: 4 warps, 128 threads) D (64 x N, fp32) = A (64 x 8) * B
// (8 x N) [+ D when scale_d], TF32, both operands K-major.  ss: A and B from
// shared memory through descriptors.  rs: A from registers, warp w of the
// group holding rows 16w..16w+15 as mma.sync's m16n8k8 A fragment (a[0]: row
// g, column t; a[1]: row g + 8, column t; a[2]: row g, column t + 4; a[3]:
// row g + 8, column t + 4).  D: d[4 i + e] is row 16w + g + 8 (e / 2),
// column 8 i + 2 t + e % 2 (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  static_assert(N == 32 || N == 64, "P V column chunks are 32 or 64 wide");
  if constexpr (N == 32) wgmma_rs_n32(d, a, desc_b, scale_d);
  else wgmma_rs_n64(d, a, desc_b, scale_d);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
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

// a warpgroup's registers per thread, lowered or raised (warp
// specialization); the raise waits until the block's own registers allow
// it, so the counts must fit what the block was launched with
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// a descriptor made opaque to the compiler, so that the per-step
// descriptors derived from it are recomputed where they are used instead
// of being hoisted out of the tile loop into registers
__device__ __forceinline__ uint64_t opaque(uint64_t d) {
  asm volatile("" : "+l"(d));
  return d;
}

// named barriers: bar_sync waits until `count` threads have arrived at
// barrier `id` (itself included); bar_arrive arrives without waiting
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- 3xTF32 -----------------------------------------------------------------

// fp32 -> TF32 as a 32-bit pattern, round to nearest with ties away from
// zero, as cvt.rna.tf32.f32 rounds, in two integer operations (inf and nan
// stay inf and nan)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// ---- staging: global -> registers -> TF32 parts in wgmma's layout ----------

// Staged data: fp32, or bf16 as its 16 bits, widened exactly by a shift.
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(uint16_t x) { return __uint_as_float((uint32_t)x << 16); }

// Four consecutive elements from p.  vec: one 16-byte (fp32) or 8-byte
// (bf16) load, which needs that alignment; else element by element.
template <typename E>
__device__ __forceinline__ float4 load4(const E* p, bool vec) {
  if (vec) {
    if constexpr (sizeof(E) == 4) {
      return *reinterpret_cast<const float4*>(p);
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                         __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
    }
  }
  return make_float4(widen(p[0]), widen(p[1]), widen(p[2]), widen(p[3]));
}

// 2^x on the special-function unit (relative error ~2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Rows row0..row0+63 of a (rows, D) operand (element offset `base` of row 0,
// row stride rs; zero at rows >= row_end and columns >= D) into the hi and
// lo TF32 parts of a 64 x DP K-major wgmma operand without swizzle: 8 x 4
// core matrices (8 rows, 4 columns; 128 bytes), element (n, c) at word
// ((n / 8) * (DP / 4) + c / 4) * 32 + (n % 8) * 4 + c % 4, so core matrices
// are 128 bytes apart along the columns and 32 * DP bytes apart along the
// rows.  A thread takes 4 columns of one row: one 16-byte store each for hi
// and lo, 8 lanes on 8 rows of one core matrix (conflict-free), 4 lanes on
// 64 contiguous bytes of a row in memory.  lo is null for bf16 data (exact
// in TF32).  Q (the A operand of S = Q K^T) and K (its B operand) both lie
// so, head_dim being their K dimension.  Loads and stores are separate
// calls, so that a tile's loads are in flight while the previous one is
// stored.
template <int DP>
struct RowUnit {   // this thread's row n and 4-column group c in pass it
  int n, c;
  __device__ __forceinline__ RowUnit(int it) {
    const int lane = threadIdx.x % 32, combo = it * 4 + (threadIdx.x / 32) % 4;
    n = (combo % 8) * 8 + lane % 8;
    c = (combo / 8) * 4 + lane / 8;
  }
};
template <int DP, typename E>
__device__ __forceinline__ void load_rows(float4 (&x)[DP / 8], const E* src, long long rs,
                                          int row0, int row_end, int D, bool vec) {
#pragma unroll
  for (int it = 0; it < DP / 8; ++it) {
    const RowUnit<DP> u(it);
    const int row = row0 + u.n;
    x[it] = row < row_end && 4 * u.c < D ? load4(src + row * rs + 4 * u.c, vec)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}
template <int DP>
__device__ __forceinline__ void store_rows(const float4 (&x)[DP / 8], uint32_t* hi, uint32_t* lo) {
#pragma unroll
  for (int it = 0; it < DP / 8; ++it) {
    const RowUnit<DP> u(it);
    const int off = ((u.n / 8) * (DP / 4) + u.c) * 32 + (u.n % 8) * 4;
    uint32_t h[4], l[4];
    split(x[it].x, h[0], l[0]);
    split(x[it].y, h[1], l[1]);
    split(x[it].z, h[2], l[2]);
    split(x[it].w, h[3], l[3]);
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    if (lo != nullptr) *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The V tile (keys k0..k0+63, all D columns) transposed into the B operand
// of O = P V, K-major: B (K = 64 key slots, N = DP columns of V), element
// (n, slot) at word ((n / 8) * 16 + slot / 4) * 32 + (n % 8) * 4 + slot % 4
// (core matrices 128 bytes apart along the slots, 2048 bytes along n).  The
// slots are the tile's keys permuted within each 8-key step u: slot 8u + s
// holds key 8u + 2s for s < 4 and key 8u + 2(s - 4) + 1 for s >= 4, so that
// the S accumulator's registers are P's A fragments as they stand (see the
// consumer).  A thread takes 4 slots of one column (4 rows of V, one element
// each, 32 lanes on 32 consecutive columns of a row) and writes one 16-byte
// run each for hi and lo (8 lanes on 8 n of one core matrix: conflict-free).
template <int DP>
struct VtUnit {    // this thread's column n and 4-slot group q in pass it
  int n, q;
  __device__ __forceinline__ VtUnit(int it) {
    const int combo = it * 4 + (threadIdx.x / 32) % 4;
    q = combo % 16;
    n = (combo / 16) * 32 + threadIdx.x % 32;
  }
};
template <int DP, typename E>
__device__ __forceinline__ void load_vt(float (&x)[DP / 8][4], const E* src, long long rs,
                                        int row0, int row_end, int D) {
#pragma unroll
  for (int it = 0; it < DP / 8; ++it) {
    const VtUnit<DP> u(it);
    const int row = row0 + 8 * (u.q / 2) + u.q % 2;   // slot 4 (u.q % 2) .. of step u.q / 2
    const E* p = src + row * rs + u.n;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[it][e] = row + 2 * e < row_end && u.n < D ? widen(p[2 * e * rs]) : 0.f;
  }
}
template <int DP>
__device__ __forceinline__ void store_vt(const float (&x)[DP / 8][4], uint32_t* hi, uint32_t* lo) {
#pragma unroll
  for (int it = 0; it < DP / 8; ++it) {
    const VtUnit<DP> u(it);
    const int off = ((u.n / 8) * 16 + u.q) * 32 + (u.n % 8) * 4;
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split(x[it][e], h[e], l[e]);
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    if (lo != nullptr) *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// ot (64 x N) = P V[:, n0:n0+N] from zero, P's parts in registers as the A
// fragments of the 8 key steps, Vh/Vl at the chunk's first column: lo*hi,
// hi*lo, hi*hi each step (LO), or without hi*lo (bf16 V, exact in TF32)
template <int N, bool LO>
__device__ __forceinline__ void pv_chunk(float (&ot)[N / 2], uint32_t (&ph)[8][4],
                                         uint32_t (&pl)[8][4], const uint32_t* Vh,
                                         const uint32_t* Vl) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    ot[i] = 0.f;
    fence_reg(ot[i]);
  }
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      fence_reg(ph[u][a]);
      fence_reg(pl[u][a]);
    }
  const uint64_t dvh = wgmma_desc(Vh, 128, 2048), dvl = wgmma_desc(Vl, 128, 2048);
  wgmma_fence();
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    wgmma_rs<N>(ot, pl[u], dvh + 16 * u, u > 0);
    if constexpr (LO) wgmma_rs<N>(ot, ph[u], dvl + 16 * u, 1);
    wgmma_rs<N>(ot, ph[u], dvh + 16 * u, 1);
  }
  wgmma_commit();
  wgmma_wait0();
  // the registers the wgmmas read and wrote stay in place until here
#pragma unroll
  for (int i = 0; i < N / 2; ++i) fence_reg(ot[i]);
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      fence_reg(ph[u][a]);
      fence_reg(pl[u][a]);
    }
}

}  // namespace
