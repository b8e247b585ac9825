// Flash attention forward: causal (or full), sliding window, tanh softcap, GQA.
//
// Replaces: src/repro/kernels/flash_attention.py `_attn_kernel` /
// `flash_attention` (Pallas, TPU); in the model it stands in for
// src/repro/models/attention.py `blocked_causal_attention`.
//
// Bound on the card: operations.  4 * D flops per (query, valid key) pair,
// taken as three TF32 passes on the tensor cores (495 TFLOP/s dense TF32 on
// an H100 SXM at 700 W, so 165 TFLOP/s of fp32-accurate products): at the
// phi3 prefill (8 x 32 heads, S = 512, D = 96, causal) 0.0782 ms against
// 0.0150 ms for its 50 MB of q/k/v/out; at Jamba's (2 x 64 heads, S =
// 1024, D = 128, kv 8 heads) 0.2084 ms; at gemma-2b's prefill (2 x 8 heads,
// S = 512, D = 256, one kv head) 0.0130 ms, at its training micro-batch (1
// x 8 heads, S = 8192) 1.6661 ms.
//
// Three routes, chosen by head_dim D alone (a choice by shape: a launch that
// fails raises, nothing gives way to another route; the C entry
// flash_attention_route says which a call takes):
//
// D <= 128 with D % 8 == 0 (phi3 96, Jamba 128, deepseek 128): both products
// on the tensor cores through wgmma, 3xTF32.
// Each fp32 operand v splits into TF32 parts hi = tf32(v) and lo = tf32(v -
// hi), and each product sums lo*hi + hi*lo + hi*hi in fp32 (lo*lo, ~2^-22
// relative, is dropped); the probability tile P, computed in fp32, is split
// like any operand.  One pass on either product misses the fp32 tolerance
// (tests/test_torch_attention_tf32.py shows it on the CPU).  bf16 q/k/v are
// exact in TF32 and are widened while staged, so the compute is one
// instance per head_dim: their lo passes drop out (S in one pass, P V in
// two: P's lo stays).
//   * A block owns 64 query rows for each multiplying warpgroup (two at D
//     <= 96, one at 128) of one (batch row, head), and loops over 64-key
//     tiles from the window's first key to the causal bound only.  Blocks
//     run heads fastest (a GQA group shares K/V in L2) and, causal, the
//     longest query tiles first.  q/k/v are read in the model layout (B, S,
//     H, D) by strides, the ragged tail of S is masked, not padded, and
//     head_dim columns D..DP-1 (DP: D rounded up to 32, 64, 96 or 128) are
//     zero in shared memory.
//   * Warp specialized: warpgroup 0 stages, the others multiply, handing
//     tiles over through named barriers.  The stager loads Q once (hi and lo
//     parts in wgmma's K-major layout without swizzle), then K and V tiles
//     through a ring of 2-4 slots (as many as fit in 227 KB beside Q), each
//     tile's loads issued before the previous one is stored.
//   * S = Q K^T: both operands are K-major as they lie (head_dim
//     contiguous): wgmma m64n64k8 with A and B from shared memory.
//   * O = P V: .tf32 wgmma takes B only K-major, and the V tile (keys x
//     head_dim) is N-major, so the stager transposes and splits it through
//     registers (one 16-byte store per 4 keys of a column).  P goes in as A
//     from registers: the stager also permutes the keys within each 8-key
//     step (slot s holds key 2s, or 2(s - 4) + 1), so that the S
//     accumulator's registers are P's A fragments as they stand, with no
//     shuffle and no trip through shared memory.
//   * Long rows: the tensor core truncates its fp32 sums, so each key
//     tile's P V is summed from zero (in column chunks that fit the
//     registers) and added to the running output in fp32 after the online
//     softmax's rescale (the one-sign row of 16384 keys in chip_smoke.py and
//     tests/test_torch_cuda.py holds it).  The softmax runs in base 2 on the
//     special-function unit.
//   * No atomics: two runs give the same bits, and the output is the same
//     whether or not the logsumexp is asked for.
//
// 128 < D <= 256 with D % 8 == 0 (Gemma's 256): the same block over a
// cluster of two CTAs that split head_dim, CTA rank r on columns [128 r,
// 128 r + 128), each the DP = 128 block on its half: a staging warpgroup,
// one multiplying warpgroup, Q's half and a ring of two K / V half tiles
// as hi and lo TF32 parts (64 + 2 x 64 KB), and a 16 KB exchange tile (208
// KB in all).  The design of the backward's cluster route
// (flash_attention_bwd.cu), with the helpers both share in cluster.cuh:
//   * S = Q K^T contracts over head_dim, so it is split: each CTA forms its
//     partial 64 x 64 tile over its 128 columns (3xTF32, each 32-column
//     chunk summed from zero and added in fp32: the tensor core truncates
//     its sums, and one accumulator over 128 one-sign columns drifted in the
//     backward), pushes it into the peer's exchange tile (distributed shared
//     memory, st.shared::cluster, then a release arrive on the peer's
//     mbarrier) and adds the peer's in fp32: rank 0's half plus rank 1's in
//     both CTAs (IEEE addition commutes), so both hold the same bits of S
//     and compute the same softcap, mask, m, l and P with no second exchange.
//   * O = P V runs along head_dim, so it stays local: each CTA multiplies P
//     (its registers, the A fragments as at D <= 128) by its own 128
//     columns of V, each key tile's product summed from zero and added in
//     fp32 after the rescale.  The running output is 64 x 128 a CTA: no
//     flop is done twice.
//   * Each CTA writes its output columns; rank 0 writes the logsumexp.
//     Deterministic, and the same output with or without the logsumexp.
//   * Instantiated with and without the softcap (CAP), so that the uncapped
//     code has no tanh.  A cluster launch the card refuses returns its
//     error.
//
// Other D <= 256 (not a multiple of 8): the SIMT kernel, one block of 256
// threads per (64-query tile, head, batch row); Q, K, V and P pass through
// shared memory, each thread keeps a 4 x 4 score tile and a 4 x (D/16)
// output tile in registers (rows ty + 16 i, columns tx + 16 j), plain fp32
// FMAs.  No model the port runs takes it.
//
// For training the caller passes a (B, H, S) float32 buffer and the kernel
// writes each row's logsumexp m + log(l) of the scaled scores there, which
// the backward (flash_attention_bwd.cu) uses to recompute the
// probabilities; serving passes null.
//
// Measured (chip_smoke.py phases 3 and 3d, NVIDIA H100 80GB HBM3 at 700
// W), against one SDPA call on the same inputs: phi3 prefill (8, 512, 32,
// 96) 0.2426 ms (SDPA 0.4686; the SIMT kernel 0.87), 32% of the bound;
// Jamba (2, 1024, 64/8, 128) 0.7013 ms (SDPA 0.9082; the SIMT kernel
// 2.09), 30% of the bound; the training shape (2, 256, 32, 96) 0.0273 ms
// of device time (SDPA's kernels 0.0475), where a call from Python spends
// as long on the host, so its CUDA-event time reads 0.027-0.051 ms by
// the host's speed.  ptxas: 244 registers at D = 128; 168 at launch with two
// multiplying warpgroups (setmaxnreg: 136 staging / 184 multiplying at D =
// 96, 120 / 192 at 32 and 64); no spills.
// The cluster route (chip_flash_bwd_ablation.py --against-fwd, device time
// in turns, the same card and limit): gemma-2b's prefill 0.0594-0.0603 ms
// (SDPA 0.1102-0.1116; 22% of its bound); gemma2's prefill, softcap 50,
// 0.0800-0.0811 (16%); gemma-2b's training micro-batch 4.68-4.72 ms (SDPA
// 7.80-7.95; 35% of its bound); gemma2's, window 4096, softcap 50,
// 5.308-5.340 (23%).  ptxas: 225 registers, no spills (both instances).
//
// What holds it back: at D <= 128 the staging warpgroup's register path
// (global loads, the split, the transposing stores) and each multiplying
// warpgroup's softmax between its two products; no TMA, and at D = 128 a
// single multiplying warpgroup (two Q tiles and a ring do not fit in 227
// KB).  The cluster route has that single warpgroup on each half, so the
// tensor cores idle through each tile's softmax, and the exchange
// serialises the two CTAs once a tile: at gemma-2b's micro-batch it reads
// 4.02-4.03 ms without the exchange, 3.29-3.32 without the products,
// 4.29-4.32 without the stager's K/V loads, against 4.69-4.70 as built
// (under the softcap the copies without loads or products read slower,
// 7.92-7.98 and 6.74-6.77 against 5.32, as the backward's did; not
// understood).
#include "tc_tf32.cuh"
#include "cluster.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// Tensor-core route (head_dim D <= 128, D % 8 == 0): 3xTF32 wgmma; its
// building blocks are in tc_tf32.cuh.
// ---------------------------------------------------------------------------

constexpr int kRows = 64;        // query rows a block
constexpr int kKeys = 64;        // keys a tile

// Multiplying warpgroups a block: two at head_dim <= 96, each with its own
// 64 query rows and both reading one K/V ring (while one runs its softmax
// the tensor cores run the other's products, and each staged tile serves
// 128 rows); one at 128, where a second Q tile leaves no room for a ring.
template <int DP>
constexpr int kGroups = DP <= 96 ? 2 : 1;

// Shared memory: Q's hi and lo parts (64 x DP each) for each multiplying
// warpgroup, then a ring of NS slots, each the hi and lo parts of one K tile
// or one transposed V tile (64 x DP each), as many as fit beside Q (at most
// 4).
template <int DP>
struct TcTile {
  static constexpr int NC = kGroups<DP>;
  static constexpr int THREADS = 128 * (1 + NC);
  // With two multiplying warpgroups, 384 threads are launched at 168
  // registers each (65536 / 384, rounded down to 8) and the staging
  // warpgroup gives some up to the multiplying ones (STAGE + 2 MUL = 3 x
  // 168); the multiplying warpgroups take P V's output columns NCH at a time,
  // so that the running output, a batch's sums and P's 64 registers fit
  // (chosen by ptxas -v: no spills).
  static constexpr int LAUNCH_REGS = 168;
  static constexpr int STAGE_REGS = DP == 96 ? 136 : 120, MUL_REGS = DP == 96 ? 184 : 192;
  static constexpr int NCH = DP == 128 ? 64 : DP == 96 ? 32 : DP;
  static_assert(NC == 1 || STAGE_REGS + 2 * MUL_REGS <= 3 * LAUNCH_REGS,
                "setmaxnreg would wait forever");
  static constexpr int PART = kRows * DP;            // words of one hi or lo part
  static constexpr int Q_BYTES = NC * 2 * PART * 4;
  static constexpr int SLOT_BYTES = 2 * PART * 4;
  static constexpr int FIT = (232448 - Q_BYTES) / SLOT_BYTES;
  static constexpr int NS = FIT < 4 ? FIT : 4;
  static constexpr int SMEM = Q_BYTES + NS * SLOT_BYTES;
  static_assert(NS >= 2, "the ring needs a K and a V slot");
};

// S (64 x 64) = Q K^T from zero on one warpgroup: lo*hi + hi*lo + hi*hi
// each 8-deep step (LO), or hi*hi alone (bf16 data, exact in TF32).  Each
// batch runs from fence to wait inside one branch-free sequence.
template <int DP, bool LO>
__device__ __forceinline__ void qk_tile(float (&s)[32], const uint32_t* Qh, const uint32_t* Ql,
                                        const uint32_t* Kh, const uint32_t* Kl) {
  // fresh zeros (s is not live across tiles), in place before the fence
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = 0.f;
    fence_reg(s[i]);
  }
  // step u's operands start 64 u words (256 u bytes, 16 u descriptor
  // units) into each part
  const uint64_t dqh = opaque(wgmma_desc(Qh, 128, 32 * DP));
  const uint64_t dql = opaque(wgmma_desc(Ql, 128, 32 * DP));
  const uint64_t dkh = wgmma_desc(Kh, 128, 32 * DP), dkl = wgmma_desc(Kl, 128, 32 * DP);
  wgmma_fence();
#pragma unroll
  for (int u = 0; u < DP / 8; ++u) {
    if constexpr (LO) {
      wgmma_ss_n64(s, dql + 16 * u, dkh + 16 * u, u > 0);
      wgmma_ss_n64(s, dqh + 16 * u, dkl + 16 * u, 1);
    }
    wgmma_ss_n64(s, dqh + 16 * u, dkh + 16 * u, LO || u > 0);
  }
  wgmma_commit();
  wgmma_wait0();
#pragma unroll
  for (int i = 0; i < 32; ++i) fence_reg(s[i]);
}

// named barriers (0 is __syncthreads): Q staged; ring slot s filled (kFull
// + s) and free again (kEmpty + s)
constexpr int kQFull = 1, kFull = 2, kEmpty = 6;

// The staging warpgroup: Q (rows q0.. of its (b, h) slice at q, 64 rows
// for each multiplying warpgroup) once, then K_0, V_0, K_1, V_1, ... (k and
// v at their (b, kv head) slices) through the ring; ring item i goes to
// slot i % NS once item i - NS is consumed.  Each tile's loads are issued
// before the previous ring item is stored.  bf16 data (E = uint16_t) is
// exact in TF32 and has no lo parts.
template <int DP, typename E>
__device__ __forceinline__ void stage(unsigned char* smem, const E* q, const E* k, const E* v,
                                      long long qrs, long long krs, long long vrs, int q0,
                                      int kv_lo, int nt, int S, int D, bool vec) {
  using Tl = TcTile<DP>;
  constexpr int NS = Tl::NS, T = Tl::THREADS;
  constexpr bool kLo = sizeof(E) == 4;
  auto hi = [&](int s) { return reinterpret_cast<uint32_t*>(smem + Tl::Q_BYTES + s * Tl::SLOT_BYTES); };
  auto lo = [&](int s) { return kLo ? hi(s) + Tl::PART : nullptr; };
  float4 xq[DP / 8], xk[DP / 8];
  float xv[DP / 8][4];
  load_rows<DP>(xk, k, krs, kv_lo, S, D, vec);
#pragma unroll
  for (int c = 0; c < Tl::NC; ++c) {
    uint32_t* Qh = reinterpret_cast<uint32_t*>(smem) + 2 * c * Tl::PART;
    load_rows<DP>(xq, q, qrs, q0 + c * kRows, S, D, vec);
    store_rows<DP>(xq, Qh, kLo ? Qh + Tl::PART : nullptr);
  }
  fence_proxy_async();
  bar_arrive(kQFull, T);
  for (int j = 0; j < nt; ++j) {
    const int k0 = kv_lo + j * kKeys;
    load_vt<DP>(xv, v, vrs, k0, S, D);
    int s = (2 * j) % NS;
    if (2 * j >= NS) bar_sync(kEmpty + s, T);
    store_rows<DP>(xk, hi(s), lo(s));
    fence_proxy_async();
    bar_arrive(kFull + s, T);
    if (j + 1 < nt) load_rows<DP>(xk, k, krs, k0 + kKeys, S, D, vec);
    s = (2 * j + 1) % NS;
    if (2 * j + 1 >= NS) bar_sync(kEmpty + s, T);
    store_vt<DP>(xv, hi(s), lo(s));
    fence_proxy_async();
    bar_arrive(kFull + s, T);
  }
}

// The online softmax over one 64-key tile on a multiplying warpgroup, in
// base 2 (scores times log2(e), m the row maxima, P = 2^(x - m)): sacc
// holds this thread's raw products q . k of rows r0 and r1 (of the
// warpgroup's 64 from qc) and keys k0 + 8 i + 2 t + e % 2 (sacc[4 i + e]),
// which are scaled (or softcapped: cap), masked and made P, split into TF32
// parts as the A fragments of the tile's 8 key steps (ph, pl).  m and l are
// updated; c0 and c1 are the rows' rescale factors for the running output.
// Rows are shared by the 4 lanes of a quad.
__device__ __forceinline__ void online_softmax(float (&sacc)[32], uint32_t (&ph)[8][4],
                                               uint32_t (&pl)[8][4], float& m0, float& m1,
                                               float& l0, float& l1, float& c0, float& c1,
                                               bool cap, float scale, float softcap, int k0,
                                               int qc, int r0, int r1, int S, int causal,
                                               int window) {
  const int t = threadIdx.x % 4;
  const float scale_l2e = scale * kLog2e, softcap_l2e = softcap * kLog2e;
  const bool full = k0 + kKeys - 1 < S && (!causal || k0 + kKeys - 1 <= qc) &&
                    (window <= 0 || k0 > qc + kRows - 1 - window);
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = cap ? softcap_l2e * tanhf(sacc[4 * i + e] * scale / softcap)
                    : sacc[4 * i + e] * scale_l2e;
      if (!full) {
        const int kpos = k0 + 8 * i + 2 * t + (e & 1), qpos = e < 2 ? r0 : r1;
        bool valid = kpos < S;
        if (causal) valid = valid && kpos <= qpos;
        if (window > 0) valid = valid && kpos > qpos - window;
        x = valid ? x : kNegInf;
      }
      sacc[4 * i + e] = x;
      if (e < 2) mx0 = fmaxf(mx0, x);
      else mx1 = fmaxf(mx1, x);
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  c0 = ex2(m0 - mn0);
  c1 = ex2(m1 - mn1);
  float rs0 = 0.f, rs1 = 0.f;
  // P's A fragment of key step i: a[0] = (r0, slot t) = key 8 i + 2 t =
  // sacc[4 i], a[1] = (r1, slot t) = sacc[4 i + 2], a[2] = (r0, slot t + 4)
  // = key 8 i + 2 t + 1 = sacc[4 i + 1], a[3] = sacc[4 i + 3]; the V tile
  // is staged with the same key order (store_vt)
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(sacc[4 * i + e] - (e < 2 ? mn0 : mn1));
      if (e < 2) rs0 += p;
      else rs1 += p;
      const int a = e == 1 ? 2 : e == 2 ? 1 : e;
      split(p, ph[i][a], pl[i][a]);
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
  }
  l0 = l0 * c0 + rs0;
  l1 = l1 * c1 + rs1;
  m0 = mn0;
  m1 = mn1;
}

// The epilogue of a multiplying warpgroup: its running output o (rows r0
// and r1, column 8 i + 2 t + e % 2 at o[4 i + e]) over l into columns
// col0.. col0 + ncols - 1 of (B, S, H, D) `out` at (b, h), and, where lse
// is given, the rows' natural logsumexp m + log(l) into (B, H, S) lse.
template <int DP>
__device__ __forceinline__ void store_out(const float (&o)[DP / 2], void* out, float* lse,
                                          int bf16, int b, int h, int S, int H, int D, int col0,
                                          int ncols, int r0, int r1, float m0, float m1,
                                          float l0, float l1) {
  const int t = threadIdx.x % 4;
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (lse != nullptr && t == 0) {
    if (r0 < S) lse[((long long)b * H + h) * S + r0] = (m0 + log2f(l0)) * kLn2;
    if (r1 < S) lse[((long long)b * H + h) * S + r1] = (m1 + log2f(l1)) * kLn2;
  }
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int col = 8 * i + 2 * t;
    if (col >= ncols) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0;
      if (r >= S) continue;
      const float inv = half ? inv1 : inv0;
      const float x0 = o[4 * i + 2 * half] * inv, x1 = o[4 * i + 2 * half + 1] * inv;
      const long long idx = (((long long)b * S + r) * H + h) * D + col0 + col;
      if (bf16)
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + idx) =
            __floats2bfloat162_rn(x0, x1);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) = make_float2(x0, x1);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(TcTile<DP>::THREADS, 1)
flash_attention_wgmma_kernel(const void* __restrict__ q, const void* __restrict__ k,
                             const void* __restrict__ v, void* __restrict__ out,
                             float* __restrict__ lse, int B, int S, int H, int Hkv, int D,
                             Strides qs, Strides ks, Strides vs, float scale, int causal,
                             int window, float softcap, int bf16, int vec) {
  using Tl = TcTile<DP>;
  constexpr int NS = Tl::NS, NC = Tl::NC, T = Tl::THREADS, BR = NC * kRows, NCH = Tl::NCH;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  auto slot_hi = [&](int s) {
    return reinterpret_cast<uint32_t*>(tc_smem + Tl::Q_BYTES + s * Tl::SLOT_BYTES);
  };
  auto slot_lo = [&](int s) { return slot_hi(s) + Tl::PART; };
  // block -> (query tile of BR rows, head, batch row), heads fastest (a GQA
  // group's blocks run together and share K/V in L2); causal: the longest
  // query tiles (the most key tiles) first
  const int nqt = (S + BR - 1) / BR;
  const int hb = blockIdx.x % (H * B), qt_rev = blockIdx.x / (H * B);
  const int h = hb % H, b = hb / H;
  const int q0 = (causal ? nqt - 1 - qt_rev : qt_rev) * BR;
  const int hk = h / (H / Hkv);
  const int kv_hi = causal ? min(S, q0 + BR) : S;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int nt = (kv_hi - kv_lo + kKeys - 1) / kKeys;   // key tiles, >= 1
  const bool has_lo = !bf16;   // bf16 q/k/v are exact in TF32: no lo parts

  if (threadIdx.x < 128) {
    if constexpr (NC > 1) setmaxnreg_dec<Tl::STAGE_REGS>();
    const long long qbase = b * qs.b + h * qs.h, kbase = b * ks.b + hk * ks.h;
    const long long vbase = b * vs.b + hk * vs.h;
    if (bf16)
      stage<DP, uint16_t>(tc_smem, static_cast<const uint16_t*>(q) + qbase,
                          static_cast<const uint16_t*>(k) + kbase,
                          static_cast<const uint16_t*>(v) + vbase, qs.s, ks.s, vs.s, q0, kv_lo,
                          nt, S, D, vec);
    else
      stage<DP, float>(tc_smem, static_cast<const float*>(q) + qbase,
                       static_cast<const float*>(k) + kbase, static_cast<const float*>(v) + vbase,
                       qs.s, ks.s, vs.s, q0, kv_lo, nt, S, D, vec);
    return;
  }

  // ---- multiplying warpgroup c: 64 query rows from qc, 16 a warp; this
  // thread holds rows r0 = qc + 16 w + g and r1 = r0 + 8.  It takes part in
  // every ring item's barriers and skips the products of the key tiles its
  // rows see none of (past their causal bound or before their window).
  if constexpr (NC > 1) setmaxnreg_inc<Tl::MUL_REGS>();
  const int c = (threadIdx.x - 128) / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int qc = q0 + c * kRows, r0 = qc + 16 * warp + g, r1 = r0 + 8;
  const int my_hi = causal ? min(S, qc + kRows) : S;
  const int my_lo = window > 0 ? max(0, qc - window + 1) : 0;
  const uint32_t* Qh = reinterpret_cast<const uint32_t*>(tc_smem) + 2 * c * Tl::PART;
  const uint32_t* Ql = Qh + Tl::PART;
  float o[DP / 2];         // running output, o[4 i + e]: row r0/r1, column 8 i + 2 t + e % 2
  float ot[NCH / 2];       // one key tile's P V (a column chunk), summed from zero
  float sacc[32];          // S, then P: sacc[4 i + e] is key 8 i + 2 t + e % 2 of the tile
  uint32_t ph[8][4], pl[8][4];   // P's TF32 parts as the A fragments of the 8 key steps
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;

  bar_sync(kQFull, T);
  for (int j = 0; j < nt; ++j) {
    const int k0 = kv_lo + j * kKeys;
    const int sk = (2 * j) % NS, sv = (2 * j + 1) % NS;
    const bool active = k0 < my_hi && k0 + kKeys > my_lo;

    // S = Q K^T (columns D..DP-1 of Q and K are zero)
    bar_sync(kFull + sk, T);
    if (active) {
      if (has_lo) qk_tile<DP, true>(sacc, Qh, Ql, slot_hi(sk), slot_lo(sk));
      else qk_tile<DP, false>(sacc, Qh, Ql, slot_hi(sk), slot_lo(sk));
    }
    if (2 * j + NS < 2 * nt) bar_arrive(kEmpty + sk, T);
    if (!active) {
      bar_sync(kFull + sv, T);
      if (2 * j + 1 + NS < 2 * nt) bar_arrive(kEmpty + sv, T);
      continue;
    }

    float c0, c1;
    online_softmax(sacc, ph, pl, m0, m1, l0, l1, c0, c1, softcap > 0.f, scale, softcap, k0, qc,
                   r0, r1, S, causal, window);

    // each column chunk's P V from zero, then o = o * corr + chunk in fp32:
    // the tensor core truncates its sums, so it never carries o
    bar_sync(kFull + sv, T);
#pragma unroll
    for (int n = 0; n < DP / NCH; ++n) {
      const uint32_t* Vh = slot_hi(sv) + n * NCH * 64;
      const uint32_t* Vl = slot_lo(sv) + n * NCH * 64;
      if (has_lo) pv_chunk<NCH, true>(ot, ph, pl, Vh, Vl);
      else pv_chunk<NCH, false>(ot, ph, pl, Vh, Vl);
#pragma unroll
      for (int i = 0; i < NCH / 2; ++i) {
        float& acc = o[n * NCH / 2 + i];
        acc = acc * (i % 4 < 2 ? c0 : c1) + ot[i];
      }
    }
    if (2 * j + 1 + NS < 2 * nt) bar_arrive(kEmpty + sv, T);
  }

  store_out<DP>(o, out, lse, bf16, b, h, S, H, D, 0, D, r0, r1, m0, m1, l0, l1);
}

template <int DP>
int launch_wgmma(int dtype, const void* q, const void* k, const void* v, void* out, float* lse,
                 int B, int S, int H, int Hkv, int D, Strides qs, Strides ks, Strides vs,
                 float scale, int causal, int window, float softcap, cudaStream_t st) {
  auto kernel = flash_attention_wgmma_kernel<DP>;
  constexpr int smem = TcTile<DP>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if constexpr (kGroups<DP> > 1) {
    // the warpgroups' setmaxnreg counts assume this launch count: refuse
    // rather than launch a block that would wait forever
    cudaFuncAttributes attr;
    if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return (int)err;
    if (attr.numRegs != TcTile<DP>::LAUNCH_REGS) return (int)cudaErrorLaunchOutOfResources;
  }
  // 16-byte (fp32) or 8-byte (bf16) loads of 4 elements need 4-element
  // aligned bases and strides
  auto al = [](const void* p, const Strides& s, int bytes) {
    return (reinterpret_cast<uintptr_t>(p) % bytes) == 0 && s.b % 4 == 0 && s.s % 4 == 0 &&
           s.h % 4 == 0;
  };
  const int bytes = dtype == 1 ? 8 : 16;
  const int vec = al(q, qs, bytes) && al(k, ks, bytes);
  const int grid = (S + kGroups<DP> * kRows - 1) / (kGroups<DP> * kRows) * H * B;
  kernel<<<grid, TcTile<DP>::THREADS, smem, st>>>(q, k, v, out, lse, B, S, H, Hkv, D, qs, ks, vs,
                                                   scale, causal, window, softcap, dtype == 1, vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core route at 128 < D <= 256 (D % 8 == 0): a cluster of two CTAs,
// each the DP = 128 block on its half of head_dim.
// ---------------------------------------------------------------------------

// Shared memory of one CTA of the pair (128 head_dim columns): TcTile<128>'s
// Q hi and lo parts and its ring of two K / V slots, then the exchange tile
// (64 x 64 fp32: the peer's partial S lands there) and the exchange's
// barriers.  208 KB of the 227 KB a block may hold.
struct TcTileX {
  using Tl = TcTile<128>;
  static constexpr int THREADS = Tl::THREADS;
  static constexpr int X_OFF = Tl::SMEM;                     // bytes: the exchange tile
  static constexpr int XBAR_OFF = X_OFF + kRows * kKeys * 4;  // then XBars
  static constexpr int SMEM = XBAR_OFF + (int)sizeof(XBars);
  static_assert(Tl::NC == 1 && Tl::NS == 2 && SMEM <= 232448, "one CTA of the pair");
};

// A CTA's partial S (64 x 64) = Q K^T over its 128 head_dim columns, from
// zero, 3xTF32 as qk_tile (or hi*hi alone: bf16), but each 32-column chunk
// summed from zero and added in fp32: the tensor core truncates its sums,
// and one accumulator over one-sign columns drifts (the backward's
// ring_product_rs sums its partials so for the same reason).
template <bool LO>
__device__ __forceinline__ void qk_half(float (&s)[32], const uint32_t* Qh, const uint32_t* Ql,
                                        const uint32_t* Kh, const uint32_t* Kl) {
  constexpr int DP = 128;
  const uint64_t dqh = opaque(wgmma_desc(Qh, 128, 32 * DP));
  const uint64_t dql = opaque(wgmma_desc(Ql, 128, 32 * DP));
  const uint64_t dkh = wgmma_desc(Kh, 128, 32 * DP), dkl = wgmma_desc(Kl, 128, 32 * DP);
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int ch = 0; ch < DP / 32; ++ch) {
    float part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      part[i] = 0.f;
      fence_reg(part[i]);
    }
    wgmma_fence();
#pragma unroll
    for (int u = 4 * ch; u < 4 * ch + 4; ++u) {
      if constexpr (LO) {
        wgmma_ss_n64(part, dql + 16 * u, dkh + 16 * u, u > 4 * ch);
        wgmma_ss_n64(part, dqh + 16 * u, dkl + 16 * u, 1);
      }
      wgmma_ss_n64(part, dqh + 16 * u, dkh + 16 * u, LO || u > 4 * ch);
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      fence_reg(part[i]);
      s[i] += part[i];
    }
  }
}

// One 64-query tile of one (batch row, head) on the head_dim columns 128
// rank.. of cluster CTA `rank`: the DP = 128 block (a staging warpgroup,
// one multiplying warpgroup) on those columns, its partial S exchanged with
// the peer and summed in fp32 (both CTAs hold the same S, so the same
// softmax, P, m and l), P V on its own columns of V.  CAP: a softcap
// (instantiated apart, so that the uncapped code has no tanh).
template <bool CAP>
__global__ void __launch_bounds__(TcTileX::THREADS, 1)
flash_attention_cluster_kernel(const void* __restrict__ q, const void* __restrict__ k,
                               const void* __restrict__ v, void* __restrict__ out,
                               float* __restrict__ lse, int B, int S, int H, int Hkv, int D,
                               Strides qs, Strides ks, Strides vs, float scale, int causal,
                               int window, float softcap, int bf16, int vec) {
  using Tl = TcTile<128>;
  constexpr int NS = Tl::NS, T = Tl::THREADS;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  auto slot_hi = [&](int s) {
    return reinterpret_cast<uint32_t*>(tc_smem + Tl::Q_BYTES + s * Tl::SLOT_BYTES);
  };
  auto slot_lo = [&](int s) { return slot_hi(s) + Tl::PART; };
  XBars* xb = reinterpret_cast<XBars*>(tc_smem + TcTileX::XBAR_OFF);
  if (threadIdx.x == 0) {
    mbar_init(&xb->xfull[0], 128);
    mbar_init(&xb->xfree[0], 128);
  }
  cluster_bars_ready();
  const uint32_t rank = cluster_rank();
  const int col0 = 128 * (int)rank, Dr = min(128, D - col0);   // this CTA's columns
  // cluster -> (query tile, head, batch row), heads fastest; causal: the
  // longest query tiles (the most key tiles) first
  const int nqt = (S + kRows - 1) / kRows, cl = blockIdx.x / 2;
  const int hb = cl % (H * B), qt_rev = cl / (H * B);
  const int h = hb % H, b = hb / H, hk = h / (H / Hkv);
  const int q0 = (causal ? nqt - 1 - qt_rev : qt_rev) * kRows;
  const int kv_hi = causal ? min(S, q0 + kRows) : S;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int nt = (kv_hi - kv_lo + kKeys - 1) / kKeys;   // key tiles, >= 1
  const bool has_lo = !bf16;

  if (threadIdx.x < 128) {
    const long long qbase = b * qs.b + h * qs.h + col0, kbase = b * ks.b + hk * ks.h + col0;
    const long long vbase = b * vs.b + hk * vs.h + col0;
    if (bf16)
      stage<128, uint16_t>(tc_smem, static_cast<const uint16_t*>(q) + qbase,
                           static_cast<const uint16_t*>(k) + kbase,
                           static_cast<const uint16_t*>(v) + vbase, qs.s, ks.s, vs.s, q0, kv_lo,
                           nt, S, Dr, vec);
    else
      stage<128, float>(tc_smem, static_cast<const float*>(q) + qbase,
                        static_cast<const float*>(k) + kbase, static_cast<const float*>(v) + vbase,
                        qs.s, ks.s, vs.s, q0, kv_lo, nt, S, Dr, vec);
    return;
  }

  // ---- the multiplying warpgroup: this thread holds rows r0 = q0 + 16 w +
  // g and r1 = r0 + 8 (every key tile is active: one warpgroup's 64 rows
  // set the tile range)
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;
  const uint32_t* Qh = reinterpret_cast<const uint32_t*>(tc_smem);
  const uint32_t* Ql = Qh + Tl::PART;
  float* xt = reinterpret_cast<float*>(tc_smem + TcTileX::X_OFF);
  float o[64];             // running output on this CTA's columns, as the DP = 128 route's
  float ot[32];            // one key tile's P V (a 64-column chunk), summed from zero
  float sacc[32];          // S, then P (key order of qk_tile's accumulator)
  uint32_t ph[8][4], pl[8][4];
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;

  bar_sync(kQFull, T);
  for (int j = 0; j < nt; ++j) {
    const int k0 = kv_lo + j * kKeys;
    const int sk = (2 * j) % NS, sv = (2 * j + 1) % NS;

    // this CTA's partial S, then the whole S: rank 0's half plus rank 1's
    bar_sync(kFull + sk, T);
    if (has_lo) qk_half<true>(sacc, Qh, Ql, slot_hi(sk), slot_lo(sk));
    else qk_half<false>(sacc, Qh, Ql, slot_hi(sk), slot_lo(sk));
    if (2 * j + NS < 2 * nt) bar_arrive(kEmpty + sk, T);
    exchange(sacc, xt, xb, 0, rank ^ 1u, j, j == nt - 1);

    float c0, c1;
    online_softmax(sacc, ph, pl, m0, m1, l0, l1, c0, c1, CAP, scale, softcap, k0, q0, r0, r1, S,
                   causal, window);

    // P V on this CTA's 128 columns of V, each 64-column chunk from zero,
    // then o = o * corr + chunk in fp32
    bar_sync(kFull + sv, T);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const uint32_t* Vh = slot_hi(sv) + n * 64 * 64;
      const uint32_t* Vl = slot_lo(sv) + n * 64 * 64;
      if (has_lo) pv_chunk<64, true>(ot, ph, pl, Vh, Vl);
      else pv_chunk<64, false>(ot, ph, pl, Vh, Vl);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float& acc = o[n * 32 + i];
        acc = acc * (i % 4 < 2 ? c0 : c1) + ot[i];
      }
    }
    if (2 * j + 1 + NS < 2 * nt) bar_arrive(kEmpty + sv, T);
  }

  // both CTAs hold the same m and l: rank 0 writes the logsumexp
  store_out<128>(o, out, rank == 0 ? lse : nullptr, bf16, b, h, S, H, D, col0, Dr, r0, r1, m0, m1,
                 l0, l1);
}

template <bool CAP>
int launch_cluster(int dtype, const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int S, int H, int Hkv, int D, Strides qs, Strides ks,
                   Strides vs, float scale, int causal, int window, float softcap,
                   cudaStream_t st) {
  auto kernel = flash_attention_cluster_kernel<CAP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TcTileX::SMEM);
  if (err != cudaSuccess) return (int)err;
  // as launch_wgmma: 4-element loads need 4-element aligned bases and
  // strides (a CTA's first column, 128, keeps the alignment)
  auto al = [](const void* p, const Strides& s, int bytes) {
    return (reinterpret_cast<uintptr_t>(p) % bytes) == 0 && s.b % 4 == 0 && s.s % 4 == 0 &&
           s.h % 4 == 0;
  };
  const int bytes = dtype == 1 ? 8 : 16;
  const int vec = al(q, qs, bytes) && al(k, ks, bytes), bf = dtype == 1;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * ((S + kRows - 1) / kRows) * H * B, 1, 1);
  cfg.blockDim = dim3(TcTileX::THREADS, 1, 1);
  cfg.dynamicSmemBytes = TcTileX::SMEM;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, q, k, v, out, lse, B, S, H, Hkv, D, qs, ks, vs, scale,
                           causal, window, softcap, bf, vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// SIMT route (head_dim not a multiple of 8): plain fp32 FMAs.
// ---------------------------------------------------------------------------
constexpr int BQ = 64, BK = 64, kThreads = 256;

// NDK = ceil(D / 16): head_dim columns of the output tile held per thread.
template <typename T, int NDK>
__global__ void __launch_bounds__(kThreads)
flash_attention_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ out,
                            float* __restrict__ lse, int S, int H, int Hkv, int D, Strides qs,
                            Strides ks, Strides vs, float scale, int causal, int window,
                            float softcap) {
  extern __shared__ float smem[];
  const int DS = D + 1;                       // padded row stride: no bank conflicts
  float* Qs = smem;                           // BQ x DS
  float* Ks = Qs + BQ * DS;                   // BK x DS
  float* Vs = Ks + BK * DS;                   // BK x D
  float* Ps = Vs + BK * D;                    // BQ x (BK + 1)

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  const T* qb = q + b * qs.b + h * qs.h;
  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    Qs[r * DS + d] = q0 + r < S ? to_f(qb[(q0 + r) * qs.s + d]) : 0.f;
  }

  float m[4], l[4], acc[4][NDK];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NDK; ++c) acc[i][c] = 0.f;
  }

  const int kv_hi = causal ? min(S, q0 + BQ) : S;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BK) {
    __syncthreads();   // previous tile's Ks/Vs/Ps reads are done (and Qs is loaded)
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const bool in = k0 + r < S;
      Ks[r * DS + d] = in ? to_f(kb[(k0 + r) * ks.s + d]) : 0.f;
      Vs[r * D + d] = in ? to_f(vb[(k0 + r) * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * DS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * DS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += a[i] * bk[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool valid = kpos < S;
        if (causal) valid = valid && kpos <= qpos;
        if (window > 0) valid = valid && kpos > qpos - window;
        s[i][j] = valid ? x : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rsum += p;
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NDK; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    for (int c2 = 0; c2 < BK; ++c2) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * (BK + 1) + c2];
#pragma unroll
      for (int c = 0; c < NDK; ++c) {
        const int d = tx + 16 * c;
        const float vv = d < D ? Vs[c2 * D + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += p[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0) lse[((long long)b * H + h) * S + qpos] = m[i] + logf(l[i]);
    T* orow = out + (((long long)b * S + qpos) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NDK; ++c) {
      const int d = tx + 16 * c;
      if (d < D) orow[d] = from_f<T>(acc[i][c] * inv);
    }
  }
}

template <typename T, int NDK>
int launch_simt(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
           int H, int Hkv, int D, Strides qs, Strides ks, Strides vs, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(2 * BQ * (D + 1) + BK * D + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(flash_attention_simt_kernel<T, NDK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attention_simt_kernel<T, NDK><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, S, H, Hkv, D, qs, ks, vs, scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_simt(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                  int S, int H, int Hkv, int D, Strides qs, Strides ks, Strides vs, float scale,
                  int causal, int window, float softcap, cudaStream_t st) {
  if (D <= 64) return launch_simt<T, 4>(q, k, v, out, lse, B, S, H, Hkv, D, qs, ks, vs, scale, causal, window, softcap, st);
  if (D <= 96) return launch_simt<T, 6>(q, k, v, out, lse, B, S, H, Hkv, D, qs, ks, vs, scale, causal, window, softcap, st);
  if (D <= 128) return launch_simt<T, 8>(q, k, v, out, lse, B, S, H, Hkv, D, qs, ks, vs, scale, causal, window, softcap, st);
  if (D <= 256) return launch_simt<T, 16>(q, k, v, out, lse, B, S, H, Hkv, D, qs, ks, vs, scale, causal, window, softcap, st);
  return (int)cudaErrorInvalidValue;
}

// The route of a call at head_dim D: 0 the SIMT kernel, 1 the tensor cores
// at D <= 128, 2 the two-CTA clusters at 128 < D <= 256 (both for head_dims
// a multiple of 8; they read rows of any alignment)
int fwd_route(int D) {
  if (D <= 0 || D % 8 || D > 256) return 0;
  return D <= 128 ? 1 : 2;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q: (B, S, H, D), k/v: (B, S, Hkv, D),
// each with unit stride on D and (B, S, H) strides in elements in qs/ks/vs.
// out: (B, S, H, D) contiguous.  window <= 0: no window; softcap <= 0: none.
// lse: null, or (B, H, S) float32 for the rows' logsumexp.
int flash_attention(int dtype, const void* q, const void* k, const void* v,
                    void* out, void* lse, int B, int S, int H, int Hkv, int D,
                    const long long* qs, const long long* ks, const long long* vs,
                    float scale, int causal, int window, float softcap,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides q3{qs[0], qs[1], qs[2]}, k3{ks[0], ks[1], ks[2]}, v3{vs[0], vs[1], vs[2]};
  float* lsef = static_cast<float*>(lse);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int route = fwd_route(D);
  if (route == 2) {
    auto go = [&](auto launch) {
      return launch(dtype, q, k, v, out, lsef, B, S, H, Hkv, D, q3, k3, v3, scale, causal,
                    window, softcap, st);
    };
    return softcap > 0.f ? go(launch_cluster<true>) : go(launch_cluster<false>);
  }
  if (route == 1) {
    // the tensor-core route, one instance per head_dim padded to DP
    auto go = [&](auto launch_dp) {
      return launch_dp(dtype, q, k, v, out, lsef, B, S, H, Hkv, D, q3, k3, v3, scale, causal,
                       window, softcap, st);
    };
    if (D <= 32) return go(launch_wgmma<32>);
    if (D <= 64) return go(launch_wgmma<64>);
    if (D <= 96) return go(launch_wgmma<96>);
    return go(launch_wgmma<128>);
  }
  if (dtype == 0)
    return dispatch_simt<float>(q, k, v, out, lsef, B, S, H, Hkv, D, q3, k3, v3, scale, causal, window, softcap, st);
  return dispatch_simt<__nv_bfloat16>(q, k, v, out, lsef, B, S, H, Hkv, D, q3, k3, v3, scale, causal, window, softcap, st);
}

// The route flash_attention takes at head_dim D (fwd_route): 0 SIMT, 1
// tensor cores (D <= 128), 2 two-CTA clusters (128 < D <= 256)
int flash_attention_route(int D) { return fwd_route(D); }

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
