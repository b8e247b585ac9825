// Decode attention: one query token per (batch row, head) against a KV cache.
//
// Replaces: src/repro/kernels/decode_attention.py `_decode_kernel` /
// `flash_decode` (Pallas, TPU), and computes what the model function it
// stands in for, src/repro/models/attention.py `decode_attention`, computes:
// GQA (q head h reads kv head h / G), per-row or shared cache_len, a sliding
// window (keys in [max(0, len - window), len)), a tanh logit softcap, fp32
// and bf16, head_dim D <= 256.
//
// Bound on the card: bytes.  A step reads the valid part of the K and V
// caches once (2 * len * Hkv * D elements per batch row) for 4 * D flops per
// (query head, key): with G query heads a KV head, 2 * G flops per cache
// byte in fp32, at most 16 at G = 8, under the H100's ~20 fp32 SIMT flops
// per byte of HBM bandwidth.  Tensor cores would buy nothing: the products
// are G x chunk x D, far too thin to leave the memory bound, so the kernel
// stays on SIMT fp32.
//
// Design (Hopper):
// 1. One CTA of 8 warps per (b, KV head, split) serves all G query heads of
//    the group (at most 8 a CTA; a larger group is cut into tiles of 8, each
//    a CTA), so each K and V row leaves device memory once per step, not G
//    times.  Where a short cache (at most 2 chunks a split) leaves the card
//    with fewer 8-head CTAs than SMs, tiles of 4 heads double the CTAs
//    (faster at Jamba's decode step, slower at its long cache); the second
//    read of each row is then an L2 hit.  (16 warps a CTA for 4-8 heads
//    spilled at 128 registers a thread and was slower at the long cache.)
// 2. The CTA's keys move into shared memory in chunks (64 keys for 1-2
//    heads, 32 for 4-8) by TMA: a whole chunk of K, and one of V, is one
//    `cp.async.bulk.tensor` box read at the cache's own strides (the tensor
//    maps are encoded on the host once per cache buffer), issued by one
//    thread and counted by the stage's mbarrier.  The ring has 2 stages for
//    1-2 heads (more CTAs share an SM) and 3 for 4-8 heads (a CTA's copies
//    run further ahead of its larger work), only as many as a split can
//    fill.  A partial last chunk is copied row by row (bulk copies), so no
//    key outside [lo, len) is read.  Caches whose rows or strides are not
//    16-byte aligned are staged by element copies.  (16-byte cp.async by
//    every thread, measured first, kept the copy pipeline itself at
//    1.8-2.3 TB/s and took the compute warps' issue slots; TMA bulk copies
//    of single rows were slower still.)
// 3. Each warp owns an eighth of every chunk's keys; lanes run along
//    head_dim (16 bytes a lane: rows read whole, no bank conflict) and hold
//    q for every head in registers.  A lane's partial dot products for
//    (head, key) pairs are summed across the lanes by a reduce-scatter
//    (each shuffle step sends half the values and keeps half: 15 shuffles
//    for 16 sums instead of 80), after which each lane holds one score.
//    Each warp keeps its own online softmax per head: one max and one
//    exponent a score, (m, l, acc) rescaled once per chunk, p and the
//    rescale factors passed to P V through shared memory; P V reads each V
//    row once for all G heads.  One block barrier a chunk, for the ring.
//    The warps' partials are merged at the end.  SIMT fp32 throughout: at
//    G x chunk x D the products are too thin for the tensor cores to pay.
// 4. Split-KV inside a thread-block cluster, in one launch: the splits of a
//    (b, KV head, tile) are the CTAs of one cluster (up to 16, non-portable
//    size, where the card places such clusters; else 8).  Each CTA divides
//    the row's valid range [lo, len) evenly (whole chunks), writes its
//    partial (m, l, acc) to its own shared memory, and after a cluster
//    barrier each CTA merges a slice of the outputs by reading its peers'
//    partials through distributed shared memory.  No scratch tensor, no
//    second launch, no atomics.  A CTA (or warp) whose keys are all outside
//    the range reads nothing and contributes m = -inf, l = 0, acc = 0,
//    weighted by exactly 0 (the guard: with every partial empty, exp(m -
//    m_all) would be NaN); an empty row gives 0 / max(l, 1e-30) = 0 as
//    before.  A second cluster barrier keeps each CTA's shared memory alive
//    until its peers have read it.  The split count comes from S on the
//    host: doubled while B * Hkv * tiles * splits is below the SM count and
//    each split keeps >= 2 chunks of a full row, or below 4x the SM count
//    and each split keeps >= 16; one split (no cluster) where the grid
//    already fills the card.
// The cache is read in its model layout (B, S, Hkv, D) by strides: no
// transposed or padded copy is made.
//
// The latent route (`decode_latent`, below the kernel above) is the same
// function for MLA's latent cache: one KV head, a key of two strided pieces
// and values narrower than the key.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 16;    // CTAs of a cluster (16: non-portable size)
constexpr int kMaxGroup = 8;      // query heads a CTA serves
constexpr int kRingBudget = 100000;   // bytes of stages, so two CTAs fit an SM at D <= 128 fp32

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of shared memory as floats
__device__ __forceinline__ void unpack16(const float* s, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* s, float* x) {
  const uint4 v = *reinterpret_cast<const uint4*>(s);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// TMA copies into shared memory, completing on an mbarrier
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile("{\n .reg .pred p;\n WAIT_%=:\n"
               " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
               " @!p bra WAIT_%=;\n}" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}
// a box of the 4-d cache (D, Hkv, S, B) at (0, hk, key, b): a chunk's rows
__device__ __forceinline__ void tma_rows(void* dst, const CUtensorMap* map, int hk, int key,
                                         int b, uint64_t* bar) {
  asm volatile("cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
               " [%0], [%1, {%2, %3, %4, %5}], [%6];"
               :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(hk),
                  "r"(key), "r"(b), "r"(smem_addr(bar)) : "memory");
}
// one row, for a chunk that ends inside the range
__device__ __forceinline__ void bulk_row(void* dst, const void* src, unsigned bytes,
                                         uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1], %2, [%3];"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Reduce-scatter of W2 = 2W values across the lanes, one halving step: the
// lanes with bit OFF set keep the upper half and send the lower, the others
// the reverse, each adding what its partner sent; then the next step.  After
// log2(2W) steps a lane holds value lane / (32 / 2W), summed over the lanes
// that differ in bits 16 .. 32 / 2W.  Compile-time counts keep vals in registers.
template <int W, int OFF>
__device__ __forceinline__ void reduce_scatter(float* vals, int lane) {
  if constexpr (W >= 1) {
    const bool up = lane & OFF;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float send = up ? vals[i] : vals[i + W];
      const float keep = up ? vals[i + W] : vals[i];
      vals[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    reduce_scatter<W / 2, OFF / 2>(vals, lane);
  }
}

// N floats from 16-byte aligned shared memory (float4 reads where N allows)
template <int N>
__device__ __forceinline__ void load_floats(const float* src, float* dst) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + i);
      dst[i] = v.x; dst[i + 1] = v.y; dst[i + 2] = v.z; dst[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = src[i];
  }
}

// a peer CTA's copy of a shared-memory address, and the cluster barrier
// (one split: no cluster, the CTA's own memory and a CTA barrier)
template <typename P>
__device__ __forceinline__ P* peer(cg::cluster_group& cluster, P* ptr, int rank, bool one) {
  return one ? ptr : cluster.map_shared_rank(ptr, rank);
}
__device__ __forceinline__ void cluster_barrier(cg::cluster_group& cluster, bool one) {
  if (one) __syncthreads(); else cluster.sync();
}

struct Params {
  CUtensorMap tk, tv;   // the K and V caches for TMA, boxes of a chunk's rows
  const void* q; const void* k; const void* v; void* out;
  const int* lens; int len_scalar;
  int H, G, S, D;
  long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale; int window; float softcap;
  int k_row, v_row;   // shared-memory bytes of a staged K / V row
  int ring;           // shared-memory bytes of the stages (or the warps' partials)
  int vec;            // 1: rows and strides 16-byte aligned, staged by TMA
};

// Compile-time shape of one instance: T, head_dim class DMAX, heads GT.
template <typename T, int DMAX, int GT>
struct Cfg {
  static constexpr int VE = 16 / (int)sizeof(T);            // elements in 16 bytes
  static constexpr int ND = DMAX / VE;                      // 16-byte groups a row, at most
  static constexpr int NV = (ND + 31) / 32;                 // groups a lane holds
  // keys a stage holds: 64 for 1-2 heads at rows up to 512 bytes (short
  // rows then take half the steps), else 32 (4-8 heads: GT times the work)
  static constexpr int CK = GT <= 2 && DMAX * (int)sizeof(T) <= 512 ? 64 : 32;
  static constexpr int KW = CK / kWarps;                    // keys a warp takes of a chunk
  static constexpr int KR = 16 / GT < KW ? 16 / GT : KW;    // keys a warp reduces at once
  static constexpr int NVAL = GT * KR;                      // (head, key) scores in a reduce
  static constexpr int STAGE_MAX = CK * 2 * DMAX * (int)sizeof(T);
  // few heads: 2 stages, so more CTAs share an SM; 4 or 8 heads (more work a
  // chunk): 3 stages where they fit, so a CTA's copies run further ahead
  static constexpr int NS = GT >= 4 && 3 * STAGE_MAX <= kRingBudget ? 3 : 2;
  // at most 128 registers (two CTAs an SM) where q and the accumulators,
  // 2 x GT x NV x VE a thread, leave room
  static constexpr int MIN_BLOCKS = GT * NV * VE <= 32 ? 2 : 1;
  static constexpr int ACC_BYTES = kWarps * GT * DMAX * 4;  // the warps' accumulators, at the end
  // floats after the ring: each warp's p and corr of a block, each warp's m
  // and l, the warps' merge weights, the CTA's m and l and 1/l, the splits' weights
  static constexpr int TAIL_FLOATS = kWarps * (GT * KW + GT) + 3 * kWarps * GT + 3 * GT +
                                     kMaxSplits * GT;

  static constexpr int TAIL_BYTES = 32 + TAIL_FLOATS * 4;   // 32: the stages' mbarriers
  // the most a launch asks for: every stage at the class's widest row
  static constexpr int SMEM_MAX = (NS * STAGE_MAX > ACC_BYTES ? NS * STAGE_MAX : ACC_BYTES) +
                                  TAIL_BYTES;
};

template <typename T, int DMAX, int GT>
__global__ void __launch_bounds__(kThreads, (Cfg<T, DMAX, GT>::MIN_BLOCKS))
decode_attention_kernel(const __grid_constant__ Params p) {
  using C = Cfg<T, DMAX, GT>;
  constexpr int VE = C::VE, NV = C::NV, CK = C::CK, KW = C::KW, KR = C::KR, NS = C::NS;
  constexpr int NVAL = C::NVAL, REP = 32 / NVAL;   // lanes holding each reduced score
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int split = blockIdx.x, nsplit = gridDim.x;   // cluster rank: the cluster spans x
  const int ntiles = (p.G + GT - 1) / GT;
  const int hk = blockIdx.y / ntiles, g0 = (blockIdx.y % ntiles) * GT, b = blockIdx.z;
  const int gc = min(GT, p.G - g0);                    // heads of this tile
  const int h0 = hk * p.G + g0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nd = (p.D + VE - 1) / VE;                  // 16-byte groups a row

  // this split's keys: the valid range [lo, len) in even whole chunks
  int len = p.lens ? p.lens[b] : p.len_scalar;
  len = min(len, p.S);
  const int lo = p.window > 0 ? max(0, len - p.window) : 0;
  const int n = max(0, len - lo);
  const int per = ((n + nsplit - 1) / nsplit + CK - 1) / CK * CK;
  const int k0 = lo + split * per;
  const int k1 = min(len, k0 + per);
  const int nchunks = k1 > k0 ? (k1 - k0 + CK - 1) / CK : 0;

  const int ringb = p.ring;
  unsigned char* ring = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + ringb);   // [NS]: stage s landed
  float* pw = reinterpret_cast<float*>(smem + ringb + 32);  // [kWarps][KW][GT]: p of a block
  float* cw = pw + kWarps * GT * KW;                    // [kWarps][GT]: its rescale factors
  float* mw = cw + kWarps * GT;                         // [kWarps][GT]: each warp's m, l
  float* lw = mw + kWarps * GT;
  float* ww = lw + kWarps * GT;                         // [kWarps][GT]: the warps' weights
  float* m_s = ww + kWarps * GT;                        // [GT]: the CTA's m, l (peers read)
  float* l_s = m_s + GT;
  float* inv_s = l_s + GT;                              // [GT]
  float* wts = inv_s + GT;                              // [kMaxSplits][GT]

  const int stage_bytes = CK * (p.k_row + p.v_row);
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  auto stage = [&](int c) {
    unsigned char* kdst = ring + (c % NS) * stage_bytes;
    unsigned char* vdst = kdst + CK * p.k_row;
    const int key0 = k0 + c * CK;
    if (p.vec) {
      // warp 0: a whole chunk is one TMA box of K and one of V; the last,
      // partial chunk is copied row by row (no key past the range is read)
      if (warp == 0) {
        const int rows = min(CK, k1 - key0);
        uint64_t* bar = &bars[c % NS];
        if (lane == 0) {
          fence_proxy_async();   // the stage's earlier reads come before the copies
          mbar_expect_tx(bar, 2u * rows * p.k_row);
          if (rows == CK) {
            tma_rows(kdst, &p.tk, hk, key0, b, bar);
            tma_rows(vdst, &p.tv, hk, key0, b, bar);
          }
        }
        __syncwarp();
        if (rows < CK) {
          for (int r = lane; r < rows; r += 32) {
            bulk_row(kdst + r * p.k_row, kb + (long long)(key0 + r) * p.k_ss, p.k_row, bar);
            bulk_row(vdst + r * p.v_row, vb + (long long)(key0 + r) * p.v_ss, p.v_row, bar);
          }
        }
      }
    } else {
      const int per_mat = CK * p.D;
      for (int i = tid; i < 2 * per_mat; i += kThreads) {
        const bool is_v = i >= per_mat;
        const int j = is_v ? i - per_mat : i;
        const int r = j / p.D, d = j - r * p.D;
        const int key = key0 + r;
        T* dst = reinterpret_cast<T*>(is_v ? vdst + r * p.v_row : kdst + r * p.k_row);
        dst[d] = key < k1 ? (is_v ? vb[key * p.v_ss + d] : kb[key * p.k_ss + d])
                          : from_f<T>(0.f);
      }
    }
  };

  // the first stages' copies go out before anything else, so their latency
  // runs under q's loads and the stage's zero rows
  if (p.vec) {
    if (warp == 0) {
      if (lane == 0) {
        for (int s = 0; s < NS; ++s) mbar_init(&bars[s], 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      }
      __syncwarp();
#pragma unroll 1
      for (int s = 0; s < NS - 1; ++s)
        if (s < nchunks) stage(s);
    }
    // a partial last chunk's rows past the range are never copied: where its
    // stage is used first by it, make them 0 (0 x an unset NaN would be NaN)
    const int tail = nchunks > 0 ? (k1 - k0) % CK : 0;
    if (tail && nchunks <= NS) {
      unsigned char* kl = ring + (nchunks - 1) * stage_bytes;
      unsigned char* vl = kl + CK * p.k_row;
      for (int i = tid; i < (CK - tail) * p.k_row / 16; i += kThreads)
        reinterpret_cast<uint4*>(kl + tail * p.k_row)[i] = make_uint4(0, 0, 0, 0);
      for (int i = tid; i < (CK - tail) * p.v_row / 16; i += kThreads)
        reinterpret_cast<uint4*>(vl + tail * p.v_row)[i] = make_uint4(0, 0, 0, 0);
    }
  } else if (nchunks > 0) {   // element copies leave the row pads: make them 0
    for (int i = tid; i < ringb / 16; i += kThreads)
      reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
#pragma unroll 1
    for (int s = 0; s < NS - 1; ++s)
      if (s < nchunks) stage(s);
  }

  // q in registers: lane holds 16-byte groups lane, lane + 32 of every head
  float qr[GT][NV][VE];
  const T* qb = static_cast<const T*>(p.q) + ((long long)b * p.H + h0) * p.D;
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int j = lane + 32 * v;
      if (p.vec && g < gc && j < nd) {   // rows of 16-byte groups: one load a group
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(qb + g * p.D + j * VE));
        unpack16(reinterpret_cast<const T*>(&raw), qr[g][v]);
#pragma unroll
        for (int e = 0; e < VE; ++e) qr[g][v][e] *= p.scale;
      } else {
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          const int d = j * VE + e;
          qr[g][v][e] = (g < gc && d < p.D) ? to_f(qb[g * p.D + d]) * p.scale : 0.f;
        }
      }
    }
  __syncthreads();

  float acc[GT][NV][VE];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[g][v][e] = 0.f;
  // after a reduce, this lane holds the score of (head hg, key kr of the
  // round's KR keys), and keeps head hg's running m and l
  const int idx = lane / REP, hg = idx / KR, kr = idx % KR;
  float m_run = -INFINITY, l_run = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    if (p.vec) mbar_wait(&bars[c % NS], (c / NS) & 1);
    __syncthreads();                 // chunk c landed; chunk c-1's stage is free
    if (c + NS - 1 < nchunks) stage(c + NS - 1);
    const unsigned char* kbuf = ring + (c % NS) * stage_bytes + warp * KW * p.k_row;
    const unsigned char* vbuf = ring + (c % NS) * stage_bytes + CK * p.k_row +
                                warp * KW * p.v_row;

    // scores of this warp's KW keys, KR at a time: partial dot products over
    // the lane's groups, then a reduce-scatter across the lanes (each step
    // sends half the values to the partner lane and keeps the other half)
    float sc[KW / KR];
#pragma unroll
    for (int rd = 0; rd < KW / KR; ++rd) {
      float vals[NVAL];
#pragma unroll
      for (int k = 0; k < KR; ++k) {
        float kx[NV][VE];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int j = lane + 32 * v;
          if (j < nd) {
            unpack16(reinterpret_cast<const T*>(kbuf + (rd * KR + k) * p.k_row) + j * VE, kx[v]);
          } else {
#pragma unroll
            for (int e = 0; e < VE; ++e) kx[v][e] = 0.f;
          }
        }
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          float s = 0.f;
#pragma unroll
          for (int v = 0; v < NV; ++v)
#pragma unroll
            for (int e = 0; e < VE; ++e) s = fmaf(qr[g][v][e], kx[v][e], s);
          vals[g * KR + k] = s;
        }
      }
      reduce_scatter<NVAL / 2, 16>(vals, lane);
      float s = vals[0];
#pragma unroll
      for (int off = REP / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
      if (k0 + c * CK + warp * KW + rd * KR + kr >= k1 || hg >= gc) s = -INFINITY;
      sc[rd] = s;
    }

    // online softmax of head hg over the warp's block: one max, one exponent
    // a score, (m, l, acc) rescaled once a block
    float bm = sc[0];
#pragma unroll
    for (int rd = 1; rd < KW / KR; ++rd) bm = fmaxf(bm, sc[rd]);
#pragma unroll
    for (int off = REP; off < KR * REP; off <<= 1) bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, off));
    const float m_new = fmaxf(m_run, bm);
    const bool any = m_new != -INFINITY;       // a valid key so far
    const float corr = any ? expf(m_run - m_new) : 1.f;
    float ps = 0.f;
#pragma unroll
    for (int rd = 0; rd < KW / KR; ++rd) {
      const float pr = any ? expf(sc[rd] - m_new) : 0.f;
      ps += pr;
      if (lane % REP == 0) pw[(warp * KW + rd * KR + kr) * GT + hg] = pr;
    }
#pragma unroll
    for (int off = REP; off < KR * REP; off <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
    l_run = l_run * corr + ps;
    m_run = m_new;
    if (lane % (REP * KR) == 0) cw[warp * GT + hg] = corr;
    __syncwarp();

    // P V: every head's accumulator for the lane's groups
    float cg_[GT];
    load_floats<GT>(cw + warp * GT, cg_);
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[g][v][e] *= cg_[g];
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      float pk[GT];
      load_floats<GT>(pw + (warp * KW + k) * GT, pk);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int j = lane + 32 * v;
        if (j < nd) {
          float vx[VE];
          unpack16(reinterpret_cast<const T*>(vbuf + k * p.v_row) + j * VE, vx);
#pragma unroll
          for (int g = 0; g < GT; ++g)
#pragma unroll
            for (int e = 0; e < VE; ++e) acc[g][v][e] = fmaf(pk[g], vx[e], acc[g][v][e]);
        }
      }
    }
    __syncwarp();
  }

  // the CTA's partial: merge the warps' (m, l, acc), an empty warp weighted 0
  if (lane % (REP * KR) == 0) { mw[warp * GT + hg] = m_run; lw[warp * GT + hg] = l_run; }
  __syncthreads();                  // the ring is free: it holds the accumulators now
  float* accb = reinterpret_cast<float*>(ring);   // [kWarps][GT][DMAX]
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int j = lane + 32 * v;
      if (j < nd) {
#pragma unroll
        for (int e = 0; e < VE; e += 4)
          *reinterpret_cast<float4*>(accb + (warp * GT + g) * DMAX + j * VE + e) =
              make_float4(acc[g][v][e], acc[g][v][e + 1], acc[g][v][e + 2], acc[g][v][e + 3]);
      }
    }
  if (tid < GT) {
    const int g = tid;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, mw[w * GT + g]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mv = mw[w * GT + g];
      const float wt = mv == -INFINITY ? 0.f : expf(mv - m);
      ww[w * GT + g] = wt;
      l = fmaf(wt, lw[w * GT + g], l);
    }
    m_s[g] = m;
    l_s[g] = l;
  }
  __syncthreads();
  for (int i = tid; i < gc * DMAX; i += kThreads) {
    const int g = i / DMAX;
    if (i - g * DMAX >= nd * VE) continue;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o = fmaf(ww[w * GT + g], accb[w * GT * DMAX + i], o);
    accb[i] = o;                    // row 0 of warp 0: read above by this thread only
  }

  // merge the cluster's partials through distributed shared memory
  const bool one = nsplit == 1;
  cluster_barrier(cluster, one);
  if (tid < gc) {
    const int g = tid;
    float m_all = -INFINITY;
    for (int r = 0; r < nsplit; ++r) m_all = fmaxf(m_all, *peer(cluster, m_s + g, r, one));
    float l_all = 0.f;
    for (int r = 0; r < nsplit; ++r) {
      const float mr = *peer(cluster, m_s + g, r, one);
      const float w = mr == -INFINITY ? 0.f : expf(mr - m_all);   // empty split: exactly 0
      wts[r * GT + g] = w;
      l_all = fmaf(w, *peer(cluster, l_s + g, r, one), l_all);
    }
    inv_s[g] = 1.f / fmaxf(l_all, 1e-30f);
  }
  __syncthreads();
  const int total = gc * p.D, slice = (total + nsplit - 1) / nsplit;
  const int end = min(total, (split + 1) * slice);
  T* ob = static_cast<T*>(p.out) + ((long long)b * p.H + h0) * p.D;
  for (int i = split * slice + tid; i < end; i += kThreads) {
    const int g = i / p.D, d = i - g * p.D;
    float o = 0.f;
#pragma unroll 4
    for (int r = 0; r < nsplit; ++r)
      o = fmaf(wts[r * GT + g], *peer(cluster, accb + g * DMAX + d, r, one), o);
    ob[i] = from_f<T>(o * inv_s[g]);
  }
  cluster_barrier(cluster, one);    // peers may still read this CTA's partials
}

constexpr int kMaxDevices = 64;

// the SMs of a device, read once
int sm_count(int dev) {
  static int sms[kMaxDevices] = {0};
  if (!sms[dev]) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

// Splits of a row: double them while the grid holds fewer CTAs than the
// card has SMs and each split would keep >= 2 chunks of the longest row S,
// or fewer than 4x the SMs and each split would keep >= 16 chunks.
int pick_splits(int rows, int S, int chunk, int sms, int max_splits) {
  const int chunks = (S + chunk - 1) / chunk;
  int P = 1;
  while (P < max_splits && ((rows * P < sms && 4 * P <= chunks) ||
                            (rows * P < 4 * sms && 16 * P <= chunks)))
    P *= 2;
  return P;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found) ==
            cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// The tensor map of a (B, S, Hkv, D) cache with strides (sb, ss, sh, 1), boxes
// of `rows` keys of one head; encoded once per cache and kept (a model's
// caches are the same buffers step after step), 64 kept in all.
int cache_map(CUtensorMap* out, const void* ptr, int dtype, int B, int S, int Hkv, int D,
              long long sb, long long ss, long long sh, int rows) {
  struct Entry { const void* ptr; long long sb, ss, sh; int dtype, B, S, Hkv, D, rows; CUtensorMap map; };
  static Entry kept[64];
  static int used = 0, next = 0;
  for (int i = 0; i < used; ++i) {
    const Entry& e = kept[i];
    if (e.ptr == ptr && e.sb == sb && e.ss == ss && e.sh == sh && e.dtype == dtype && e.B == B &&
        e.S == S && e.Hkv == Hkv && e.D == D && e.rows == rows) {
      *out = e.map;
      return 0;
    }
  }
  EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  const int es = dtype == 0 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(sh * es), (cuuint64_t)(ss * es), (cuuint64_t)(sb * es)};
  const cuuint32_t box[4] = {(cuuint32_t)D, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  Entry e = {ptr, sb, ss, sh, dtype, B, S, Hkv, D, rows, {}};
  const CUresult r = encode(&e.map, dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            4, const_cast<void*>(ptr), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  kept[next] = e;
  next = (next + 1) % 64;
  if (used < 64) ++used;
  *out = e.map;
  return 0;
}

// Once per device and kernel instance: the shared-memory limit and the
// cluster attributes.  Returns the most splits a cluster may take there
// (16 where a cluster of 16 CTAs can be resident, else 8), or minus the
// cudaError_t of a refused attribute.
template <typename T, int DMAX, int GT>
int max_splits(int dev) {
  using C = Cfg<T, DMAX, GT>;
  auto kern = decode_attention_kernel<T, DMAX, GT>;
  static int most[kMaxDevices] = {0};
  if (!most[dev]) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return -(int)e;
    cudaLaunchConfig_t qc = {};
    cudaLaunchAttribute qa[1];
    qa[0].id = cudaLaunchAttributeClusterDimension;
    qa[0].val.clusterDim.x = kMaxSplits; qa[0].val.clusterDim.y = 1; qa[0].val.clusterDim.z = 1;
    qc.gridDim = dim3(kMaxSplits, 1, 1);
    qc.blockDim = dim3(kThreads, 1, 1);
    qc.dynamicSmemBytes = C::SMEM_MAX;
    qc.attrs = qa;
    qc.numAttrs = 1;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, kern, &qc) != cudaSuccess) {
      cudaGetLastError();   // a refused query only means: no clusters of 16
      clusters = 0;
    }
    most[dev] = clusters > 0 ? kMaxSplits : kMaxSplits / 2;
  }
  return most[dev];
}

// The splits of each row for the GT-head kernel at p's shape on `dev`, or
// minus a cudaError_t: the one place the split count is chosen.
template <typename T, int DMAX, int GT>
int splits(const Params& p, int B, int Hkv, int dev) {
  const int most = max_splits<T, DMAX, GT>(dev);
  if (most < 0) return most;
  const int rows = B * Hkv * ((p.G + GT - 1) / GT);
  return pick_splits(rows, p.S, Cfg<T, DMAX, GT>::CK, sm_count(dev), most);
}

// One launch of the GT-head kernel with P splits a row (from `splits`).
template <typename T, int DMAX, int GT>
int launch(Params p, int B, int Hkv, int P, cudaStream_t stream) {
  using C = Cfg<T, DMAX, GT>;
  if (p.vec) {
    const int dtype = sizeof(T) == 4 ? 0 : 1;
    int e = cache_map(&p.tk, p.k, dtype, B, p.S, Hkv, p.D, p.k_sb, p.k_ss, p.k_sh, C::CK);
    if (!e) e = cache_map(&p.tv, p.v, dtype, B, p.S, Hkv, p.D, p.v_sb, p.v_ss, p.v_sh, C::CK);
    if (e) return e;
  }
  const int ntiles = (p.G + GT - 1) / GT;

  // only the stages a split can fill: a short cache takes less shared memory
  const int per = ((p.S + P - 1) / P + C::CK - 1) / C::CK;
  const int stages = per < C::NS ? (per > 0 ? per : 1) : C::NS;
  const int ring = stages * C::CK * (p.k_row + p.v_row);
  p.ring = ((ring > C::ACC_BYTES ? ring : C::ACC_BYTES) + 15) / 16 * 16;

  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P; attr[0].val.clusterDim.y = 1; attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(P, Hkv * ntiles, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = p.ring + C::TAIL_BYTES;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = P > 1 ? 1 : 0;   // one split: no cluster
  return (int)cudaLaunchKernelEx(&cfg, decode_attention_kernel<T, DMAX, GT>, p);
}

// The split count for GT heads a CTA, then the launch.
template <typename T, int DMAX, int GT>
int run(const Params& p, int B, int Hkv, int dev, cudaStream_t st) {
  const int P = splits<T, DMAX, GT>(p, B, Hkv, dev);
  return P < 0 ? -P : launch<T, DMAX, GT>(p, B, Hkv, P, st);
}

template <typename T, int DMAX>
int by_group(const Params& p, int B, int Hkv, cudaStream_t st) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (p.G >= kMaxGroup) {
    // A short cache (at most 2 chunks a split) whose 8-head CTAs would not
    // fill the card: tiles of 4 heads, twice the CTAs, the second read of
    // each row an L2 hit.  A long cache keeps one read of each row a step.
    const int P = splits<T, DMAX, kMaxGroup>(p, B, Hkv, dev);
    if (P < 0) return -P;
    constexpr int ck = Cfg<T, DMAX, kMaxGroup>::CK;
    const int rows = B * Hkv * ((p.G + kMaxGroup - 1) / kMaxGroup);
    if (rows * P < sm_count(dev) && (p.S + ck - 1) / ck <= 2 * P)
      return run<T, DMAX, 4>(p, B, Hkv, dev, st);
    return launch<T, DMAX, kMaxGroup>(p, B, Hkv, P, st);
  }
  if (p.G > 2) return run<T, DMAX, 4>(p, B, Hkv, dev, st);
  if (p.G == 2) return run<T, DMAX, 2>(p, B, Hkv, dev, st);
  return run<T, DMAX, 1>(p, B, Hkv, dev, st);
}

template <typename T>
int dispatch(Params p, int B, int Hkv, cudaStream_t st) {
  const int es = (int)sizeof(T);
  const bool vec = (reinterpret_cast<uintptr_t>(p.k) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(p.q) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(p.v) % 16 == 0) &&
                   (p.D * es) % 16 == 0 && (p.k_sb * es) % 16 == 0 &&
                   (p.k_ss * es) % 16 == 0 && (p.k_sh * es) % 16 == 0 &&
                   (p.v_sb * es) % 16 == 0 && (p.v_ss * es) % 16 == 0 &&
                   (p.v_sh * es) % 16 == 0;
  const int row = (p.D * es + 15) / 16 * 16;
  p.vec = vec;
  p.k_row = p.v_row = row;
  if (p.D <= 64) return by_group<T, 64>(p, B, Hkv, st);
  if (p.D <= 128) return by_group<T, 128>(p, B, Hkv, st);
  if (p.D <= 256) return by_group<T, 256>(p, B, Hkv, st);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The latent route: DeepSeek-V3's MLA decode (src/repro/models/attention.py
// `mla_decode`, lines 454-487, which repro computes with einsums and no
// kernel of its own; it is flash_decode's function at one KV head).  The
// query of head h is q_lat ‖ q_rope (R + Dr = 512 + 64 wide), the key of
// every head the latent cache row c_kv ‖ k_rope, the value c_kv (R wide):
// MQA in latent space, each row at its own length.
//
// Bound on the card: operations.  Every head reads the same key and value
// rows, so a step moves the cache once (len * (R + Dr) floats a batch row)
// for 2 * (2R + Dr) flops a (head, key): at 128 heads, 64 flops a byte.
//
// Design (simple SIMT, float32): one CTA of 8 warps serves 16 heads of one
// batch row over one split of the keys; the splits of a row (from S on the
// host) write partial (m, l, acc) to a scratch that a second launch merges.
// The keys move in chunks of 32 rows, c_kv and k_rope read by their own
// strides into one shared row each (R + Dr floats, padded so that rows
// start 16 bytes apart modulo the banks), by 16-byte cp.async in two
// stages: chunk c + 1 is in flight while chunk c is used.  q, scaled,
// waits in shared memory for the CTA.  Each warp owns 2 heads: in the
// scores a lane owns a key (float4 reads of its row, q broadcast); the
// online softmax is a warp reduction a head and chunk; in P V a lane owns
// 16 of the R value columns (4 float4 groups) and takes each key's p by
// shuffle.  The chunk is read from device memory once for the CTA's 16
// heads (the other CTAs of the row find it in L2).
constexpr int kLatHeads = 16;       // query heads a CTA serves, 2 a warp
constexpr int kLatKeys = 32;        // keys a chunk: a lane each in the scores
constexpr int kLatMaxR = 512;       // value columns at most: 4 float4 groups a lane
constexpr int kLatMaxWidth = 576;   // R + Dr at most
constexpr int kLatMaxSplits = 16;
static_assert(kThreads == 32 * kLatHeads / 2, "the latent route's warps own 2 heads each");
static_assert(kLatKeys == 32, "a lane owns a key of the chunk in the scores");

struct LatentParams {
  const float* q_lat; const float* q_rope; const float* ckv; const float* krope;
  float* out;
  float* part;         // splits > 1: partial acc (B, H, P, R), then (m, l) (B, H, P, 2)
  const int* lens; int len_scalar;
  int B, H, S, R, Dr;
  int RS;              // floats between shared rows: >= R + Dr, = 4 modulo 8
  long long c_sb, c_ss, k_sb, k_ss;
  float scale;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, s))));
}

// one head's online softmax over a chunk: s is this lane's score (-inf past
// the range); returns this lane's p and rescales (m, l); corr is the
// factor for the accumulator
__device__ __forceinline__ float online_update(float s, float& m, float& l, float& corr) {
  const float m_new = fmaxf(m, warp_max(s));
  const bool any = m_new != -INFINITY;
  corr = any ? expf(m - m_new) : 1.f;
  const float pr = any ? expf(s - m_new) : 0.f;
  l = l * corr + warp_sum(pr);
  m = m_new;
  return pr;
}

__global__ void __launch_bounds__(kThreads, 1)
decode_latent_kernel(const __grid_constant__ LatentParams p) {
  extern __shared__ __align__(16) float lsm[];
  const int RS = p.RS, W = p.R + p.Dr;
  float* qs = lsm;                           // [kLatHeads][RS]: scale * (q_lat ‖ q_rope)
  float* ks = lsm + kLatHeads * RS;          // [2][kLatKeys][RS]: c_kv ‖ k_rope rows
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int h0 = blockIdx.y * kLatHeads, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // this split's keys: [0, len) in even whole chunks
  int len = p.lens ? p.lens[b] : p.len_scalar;
  len = max(0, min(len, p.S));
  const int per = ((len + nsplit - 1) / nsplit + kLatKeys - 1) / kLatKeys * kLatKeys;
  const int k0 = split * per, k1 = min(len, k0 + per);
  const int nchunks = k1 > k0 ? (k1 - k0 + kLatKeys - 1) / kLatKeys : 0;

  const float* cb = p.ckv + b * p.c_sb;
  const float* rb = p.krope + b * p.k_sb;
  const int gr = p.R / 4, gw = W / 4;        // 16-byte groups of c_kv, of a row
  auto stage = [&](int c) {
    float* dst = ks + (c & 1) * kLatKeys * RS;
    const int key0 = k0 + c * kLatKeys;
    for (int i = tid; i < kLatKeys * gw; i += kThreads) {
      const int r = i / gw, j = i - r * gw, key = key0 + r;
      const bool in = key < k1;              // rows past the range are zero-filled
      const long long row = in ? key : 0;
      const float* src = j < gr ? cb + row * p.c_ss + 4 * j : rb + row * p.k_ss + 4 * (j - gr);
      cp_async16(dst + r * RS + 4 * j, src, in ? 16 : 0);
    }
    cp_async_commit();
  };
  if (nchunks > 0) stage(0);

  for (int i = tid; i < kLatHeads * W; i += kThreads) {
    const int g = i / W, d = i - g * W, h = h0 + g;
    float v = 0.f;
    if (h < p.H) {
      const long long row = (long long)b * p.H + h;
      v = d < p.R ? p.q_lat[row * p.R + d] : p.q_rope[row * p.Dr + (d - p.R)];
    }
    qs[g * RS + d] = v * p.scale;
  }

  const float* qa = qs + (2 * warp) * RS;
  const float* qb = qa + RS;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float acc_a[4][4], acc_b[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_a[j][e] = acc_b[j][e] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      stage(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                         // chunk c (and q) in shared memory
    const float* kc = ks + (c & 1) * kLatKeys * RS;

    // scores: this lane's key against the warp's two heads
    const float* kr = kc + lane * RS;
    float sa = 0.f, sb = 0.f;
#pragma unroll 4
    for (int d = 0; d < W; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
      sa = dot4(*reinterpret_cast<const float4*>(qa + d), kv, sa);
      sb = dot4(*reinterpret_cast<const float4*>(qb + d), kv, sb);
    }
    if (k0 + c * kLatKeys + lane >= k1) sa = sb = -INFINITY;
    float corr_a, corr_b;
    const float pa = online_update(sa, m_a, l_a, corr_a);
    const float pb = online_update(sb, m_b, l_b, corr_b);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) { acc_a[j][e] *= corr_a; acc_b[j][e] *= corr_b; }

    // P V: the lane's value columns 4 (lane + 32 j) .. + 3 of every key
#pragma unroll 4
    for (int k = 0; k < kLatKeys; ++k) {
      const float wa = __shfl_sync(0xffffffffu, pa, k);
      const float wb = __shfl_sync(0xffffffffu, pb, k);
      const float* vr = kc + k * RS;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 4 * (lane + 32 * j);
        if (col < p.R) {
          const float4 v = *reinterpret_cast<const float4*>(vr + col);
          acc_a[j][0] = fmaf(wa, v.x, acc_a[j][0]); acc_a[j][1] = fmaf(wa, v.y, acc_a[j][1]);
          acc_a[j][2] = fmaf(wa, v.z, acc_a[j][2]); acc_a[j][3] = fmaf(wa, v.w, acc_a[j][3]);
          acc_b[j][0] = fmaf(wb, v.x, acc_b[j][0]); acc_b[j][1] = fmaf(wb, v.y, acc_b[j][1]);
          acc_b[j][2] = fmaf(wb, v.z, acc_b[j][2]); acc_b[j][3] = fmaf(wb, v.w, acc_b[j][3]);
        }
      }
    }
    __syncthreads();                         // chunk c is read: its stage may refill
  }

  // the warp's two heads: the output (one split) or this split's partial
  auto emit = [&](int h, float m, float l, const float (&acc)[4][4]) {
    if (h >= p.H) return;
    const long long row = (long long)b * p.H + h;
    float* dst;
    float inv = 1.f;
    if (nsplit == 1) {
      dst = p.out + row * p.R;
      inv = 1.f / fmaxf(l, 1e-30f);          // an empty row gives 0
    } else {
      dst = p.part + (row * nsplit + split) * p.R;
      if (lane == 0) {
        float* ml = p.part + (long long)p.B * p.H * nsplit * p.R + (row * nsplit + split) * 2;
        ml[0] = m;
        ml[1] = l;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 4 * (lane + 32 * j);
      if (col < p.R)
        *reinterpret_cast<float4*>(dst + col) =
            make_float4(acc[j][0] * inv, acc[j][1] * inv, acc[j][2] * inv, acc[j][3] * inv);
    }
  };
  emit(h0 + 2 * warp, m_a, l_a, acc_a);
  emit(h0 + 2 * warp + 1, m_b, l_b, acc_b);
}

// the splits' partials of one (b, head) merged: each weighted by exp(m_s -
// m_all), an empty split (m = -inf) by exactly 0
__global__ void decode_latent_merge(const __grid_constant__ LatentParams p, int nsplit) {
  const int h = blockIdx.x, b = blockIdx.y;
  const long long row = (long long)b * p.H + h;
  const float* po = p.part + row * nsplit * p.R;
  const float* ml = p.part + (long long)p.B * p.H * nsplit * p.R + row * nsplit * 2;
  float m_all = -INFINITY;
  for (int s = 0; s < nsplit; ++s) m_all = fmaxf(m_all, ml[2 * s]);
  for (int col = 4 * threadIdx.x; col < p.R; col += 4 * blockDim.x) {
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    float l = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float w = ml[2 * s] == -INFINITY ? 0.f : expf(ml[2 * s] - m_all);
      l = fmaf(w, ml[2 * s + 1], l);
      const float4 a = *reinterpret_cast<const float4*>(po + s * p.R + col);
      o.x = fmaf(w, a.x, o.x); o.y = fmaf(w, a.y, o.y);
      o.z = fmaf(w, a.z, o.z); o.w = fmaf(w, a.w, o.w);
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    *reinterpret_cast<float4*>(p.out + row * p.R + col) =
        make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv);
  }
}

// shared-memory bytes of the latent kernel at row stride RS
int latent_smem(int RS) { return (kLatHeads + 2 * kLatKeys) * RS * 4; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q/out: (B, H, D) contiguous.  k/v:
// (B, S, Hkv, D) with unit stride on D; ks/vs hold the (B, S, Hkv) strides
// in elements.  lens: (B,) int32 on the device, or null to use len_scalar.
// window <= 0 means no window; softcap <= 0 means no cap.  One launch.
int decode_attention(int dtype, const void* q, const void* k, const void* v,
                     void* out, const int* lens, int len_scalar, int B, int H,
                     int Hkv, int S, int D, const long long* ks,
                     const long long* vs, float scale, int window,
                     float softcap, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv || D <= 0 || D > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.out = out;
  p.lens = lens; p.len_scalar = len_scalar;
  p.H = H; p.G = H / Hkv; p.S = S; p.D = D;
  p.k_sb = ks[0]; p.k_ss = ks[1]; p.k_sh = ks[2];
  p.v_sb = vs[0]; p.v_ss = vs[1]; p.v_sh = vs[2];
  p.scale = scale; p.window = window; p.softcap = softcap;
  if (dtype == 0) return dispatch<float>(p, B, Hkv, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, B, Hkv, st);
  return (int)cudaErrorInvalidValue;
}

// The latent route (MLA decode), float32.  q_lat (B, H, R) and q_rope (B, H,
// Dr) contiguous; ckv (B, S, R) and krope (B, S, Dr) with unit stride on the
// last dim and the (B, S) strides given in elements; out (B, H, R).  part:
// (B * H * splits * (R + 2)) floats of scratch when splits > 1.  lens: (B,)
// int32 on the device, or null to use len_scalar.  R <= 512 and R + Dr <= 576,
// multiples of 4; pointers and row strides 16-byte aligned.  One launch, and
// a second (the merge) when splits > 1.
int decode_latent(const float* q_lat, const float* q_rope, const float* ckv,
                  const float* krope, float* out, float* part, const int* lens,
                  int len_scalar, int B, int H, int S, int R, int Dr, long long c_sb,
                  long long c_ss, long long k_sb, long long k_ss, float scale,
                  int splits, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || R <= 0 || Dr < 0 || R % 4 || Dr % 4 || R > kLatMaxR ||
      R + Dr > kLatMaxWidth || splits < 1 || splits > kLatMaxSplits ||
      (splits > 1 && !part))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  static bool ready[kMaxDevices] = {false};
  if (!ready[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_latent_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        latent_smem(kLatMaxWidth + 4));
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  LatentParams p = {};
  p.q_lat = q_lat; p.q_rope = q_rope; p.ckv = ckv; p.krope = krope;
  p.out = out; p.part = part; p.lens = lens; p.len_scalar = len_scalar;
  p.B = B; p.H = H; p.S = S; p.R = R; p.Dr = Dr;
  p.RS = (R + Dr + 7) / 8 * 8 + 4;
  p.c_sb = c_sb; p.c_ss = c_ss; p.k_sb = k_sb; p.k_ss = k_ss;
  p.scale = scale;
  const dim3 grid(splits, (H + kLatHeads - 1) / kLatHeads, B);
  decode_latent_kernel<<<grid, kThreads, latent_smem(p.RS), st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  decode_latent_merge<<<dim3(H, B), 128, 0, st>>>(p, splits);
  return (int)cudaGetLastError();
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
