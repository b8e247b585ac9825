// Flash attention backward: dQ, dK, dV for causal (or full), sliding-window,
// tanh-softcapped and GQA attention, recomputing the probabilities from the
// forward's logsumexp.
//
// Replaces: the gradient of src/repro/models/attention.py
// `blocked_causal_attention`, which repro takes by XLA autodiff; its
// forward is src/repro/kernels/flash_attention.py `_attn_kernel` (Pallas,
// TPU), ported in flash_attention.cu.  repro has no backward Pallas kernel;
// the port's forward runs through a kernel, so its gradient needs one.
//
// Math (A = scale * Q K^T; S = A, or S = c tanh(A / c) under a softcap c;
// P = softmax(S) under the mask, O = P V):
//   Dvec_i = rowsum(dO_i * O_i)
//   P_ij   = exp(S_ij - LSE_i)            (LSE from the forward)
//   dV     = P^T dO,  dP = dO V^T,  dS = P * (dP - Dvec)
//   dA     = dS, or dS * (1 - (S / c)^2) under a softcap (tanh' = 1 - tanh^2)
//   dQ     = scale * dA K,  dK = scale * dA^T Q
// S is recomputed from A as the forward computes it (c * tanhf(A / c)) before
// P; every route applies the softcap's factor.
//
// Bound on the card: bytes.  q, k, v, o and dO read once, dq, dk and dv
// written once, and the logsumexp: at the training shape (2, 256, 32, 96)
// causal fp32, 50.4 MB at 3.35 TB/s = 0.0150 ms; the five products' 10 * D
// flops a (query, valid key) pair as three TF32 passes at 495 TFLOP/s take
// 0.0122 ms.
//
// Three launches, no atomics (two runs give the same bits): Dvec by rows,
// then dK/dV by key tile, then dQ by query tile (a fourth, at head_dim 256,
// sums the dK/dV pass's parts: below).  The two passes recompute S and dP
// (14 * D flops a pair instead of 10 * D), the price of keeping dQ free of
// atomics and of a scratch buffer for per-tile partials.
//
// Three routes, chosen by head_dim D and the rows' alignment (a launch that
// fails raises; nothing gives way to another route; the C entry
// flash_attention_bwd_route says which a call takes):
//
// D <= 128 with D % 8 == 0 (phi3's 96, Jamba's 128) and rows that can be
// copied 4 elements at a time (bases and strides aligned to 4 elements):
// every product on the tensor cores through wgmma, 3xTF32 (each fp32
// operand v, P and dS included, split into hi = tf32(v) and lo = tf32(v -
// hi); each product sums lo*hi + hi*lo + hi*hi).  One pass on any one of the five products
// misses the fp32 tolerance (tests/test_torch_attention_bwd_tf32.py shows
// it on the CPU); bf16 inputs run the same passes (their lo parts are zero).
//   * A block is four warpgroups: two stagers and two consumers.  The
//     stagers (even and odd chunks) copy 64-row x 32-column chunks of q, k,
//     v and dO in the model layout (B, S, H, D) by strides (the ragged tail
//     of S zero-filled, not padded) with cp.async into small raw rings, so
//     that chunks are in flight without holding registers, then split each
//     and store it in wgmma's K-major layout, either as it lies (head_dim
//     the contraction) or transposed with the forward's 8-step row
//     permutation (rows the contraction).  Two operands stay resident for
//     the block (K and V, or Q and dO); the others stream through a ring of
//     16 KB slots.  Staging sets the time: a product needs 3 chunks (the
//     forward 1.5), and a second stager was worth 15%.
//   * dK/dV pass, a block per (64-key tile, kv head, batch row), looping
//     over the GQA group's q heads and the 64-query tiles that see its keys
//     (so dK/dV are summed over the group without atomics).  Rows are keys:
//     consumer 0 computes S^T = K Q^T and P^T, hands P^T to consumer 1
//     through shared memory, and accumulates dV += P^T dO; consumer 1
//     computes dP^T = V dO^T, dS^T = P^T (dP^T - Dvec) and dK += dS^T Q.
//     P^T and dS^T are the accumulators of transposed products, so their
//     registers are the A fragments of the next product as they stand; their
//     B operands (dO, Q over queries) are staged transposed.
//   * dQ pass, a block per (64-query tile, head, batch row): consumer 0
//     computes S = Q K^T and P, consumer 1 dP = dO V^T, dS and dQ += dS K
//     (K staged transposed).
//   * Shared by two consumers, a ring slot's "filled" signal is an
//     mbarrier per (slot, consumer), with the consumer's phase bit per
//     slot; "read" is one mbarrier per slot.  Named barriers could not say
//     for whom a slot was filled.
//   * Long sums: the tensor core truncates its fp32 sums, so each tile's
//     dV, dK and dQ are summed from zero in 32-column chunks and added to the
//     running sums in fp32 (8192 causal rows of one-sign dO and V in
//     chip_smoke.py and tests/test_torch_cuda.py hold it).
//   * Cancellation: dS = P (dP - Dvec) subtracts two sums over head_dim
//     that are large when V and O share an offset (one-sign data: both ~141
//     at head_dim 128 for a difference ~0.3), and dP's truncated sums then
//     leave an error of ~1e-4 in dK.  So the stagers subtract mu = V's row
//     0 (of the kv head) from every staged V row and the row pass takes
//     Dvec = rowsum(dO * (O - mu)): dP - Dvec is unchanged, both terms are
//     small.
//
//   * Softcap: consumer 0 recomputes S = c tanh(A / c) from the raw
//     product and P from it, and hands consumer 1 P (1 - (S / c)^2) in
//     place of P: consumer 1 uses P only to form dS, so its dS is dA.  The
//     kernels are instantiated with and without it (CAP), so that the
//     instance without a softcap is the code measured below.
//
// 128 < D <= 256 with D % 8 == 0 (Gemma's 256) and aligned rows: the same
// blocks, 3xTF32 on the tensor cores, over a cluster of two CTAs that split
// head_dim, each the DP = 128 block on 128 columns.  The DP = 128 design
// does not fit one CTA at 256: its two resident operands, split into hi and
// lo, would take 256 KB of the 227 KB a block may hold, and each consumer's
// running 64 x 256 fp32 sum (128 registers a thread) with the A fragments
// (64) and a chunk product (16) passes the ~200 registers setmaxnreg can
// give it.  Split over two CTAs:
//   * The products that contract over head_dim (S^T = K Q^T and dP^T = V
//     dO^T in the dK/dV pass, S = Q K^T and dP = dO V^T in the dQ pass)
//     are formed by each CTA over its 128 columns as a partial 64 x 64
//     tile, pushed into the peer's shared memory (distributed shared
//     memory, st.shared::cluster, then a release arrive on the peer's
//     mbarrier) and added in fp32: rank 0's half plus rank 1's, the same
//     bits in both CTAs (IEEE addition commutes), so both form the same P
//     and dS.  The products whose output runs along head_dim (dV = P^T dO,
//     dK = dS^T Q, dQ = dS K) are computed by each CTA on its own columns:
//     no flop is done twice, and each consumer's running sums stay 64 x 128
//     (ptxas shows no spills: see the measured note below).
//   * The exchange needs two 16 KB tiles beside the DP = 128 layout, which
//     has none to spare (its ring holds only NS = C = 4 chunks).  They come
//     from the residents: K and V (Q and dO in the dQ pass) stay plain fp32
//     (64 KB instead of 128 KB of hi and lo parts, rows swizzled: store_res)
//     and are split into TF32 parts in registers at each k-step, as the A
//     operand of wgmma's register form (ring_product_rs, wgmma_rs).  That
//     frees room for the exchange tiles beside a ring of 4 chunks and two
//     raw slots a stager.  (Time-sharing the P hand-over tile for the
//     exchange was the other way: it would have chained the two consumers'
//     exchanges.)
//   * Long contractions: at head_dim 256 one-sign q . k reaches ~64, twice
//     the D = 128 route's, and a partial summed in one truncating
//     accumulator drifted (P, and dV through it, 1.43e-4 from float64 on
//     the one-sign case of chip_smoke.py phase 10a); so ring_product_rs,
//     like the output products, sums each 32-column chunk from zero and
//     adds it in fp32, and the peer's half is added in fp32.
//   * The dQ pass's consumers share dQ's product (64 columns each of the
//     CTA's 128, dS handed back through the P tile): with one consumer
//     doing dP's product and dQ's, it did twice the other's work.
//   * MQA: gemma-2b's one kv head gives the dK/dV pass 8 key tiles x 1 x 2
//     = 16 clusters (32 blocks) at its prefill, a quarter of the SMs.  The
//     pass splits each GQA group's q heads into g parts, a cluster each,
//     which write fp32 partials (dK already scaled) to a (2, g, B, S, Hkv,
//     D) scratch that flash_bwd_sum_parts_kernel sums in the order p = 0,
//     1, .. (no atomics: the same bits every run).  The caller chooses g
//     (the Python wrapper's bwd_kv_split: the least g that gives a block an
//     SM, g = 1 where the pass already fills the card, as at gemma2's
//     training micro-batch) and owns the scratch.
//   * Everything else is the DP = 128 route's: mu subtracted from V by the
//     stagers and Dvec = rowsum(dO * (O - mu)) by the row pass (VEC 2: two
//     4-element runs a lane), each tile's dK, dV, dQ summed from zero per
//     32-column chunk and added in fp32, the softcap's factor handed over as
//     P (1 - (S / c)^2), instances with and without CAP, bf16 the same
//     passes.  A cluster launch the card refuses, or a register count other
//     than the one setmaxnreg assumes, returns the error: nothing gives way
//     to the SIMT kernels.
//   Measured (chip_flash_bwd_ablation.py --against the SIMT-only source,
//   device time, NVIDIA H100 80GB HBM3 at 700.00 W): gemma2's training
//   micro-batch (1, 8192, 8/4, 256), window 4096, softcap 50, 15.44-15.46
//   ms against the SIMT kernels' 61.03-61.04 (20% of its 3.12 ms bound);
//   gemma-2b's MQA prefill (2, 512, 8/1, 256), g = 8, 0.222 against 3.09;
//   gemma2's prefill, softcap 50, g = 2, 0.243-0.246 against 1.17.  At
//   gemma-2b's prefill it reads 0.19 without the stagers' global loads,
//   0.18 without the products, 0.19 without the ring stores.  Interleaving
//   the two consumers' ring items (a stager for each) read 0.248 and 18.7
//   ms: two stagers on one consumer's chunks stage them twice as fast.
//   ptxas: 128 registers at launch (setmaxnreg 56 staging / 200
//   multiplying), no spills: ring_product_rs takes 2 k-steps a batch in the
//   dK/dV pass and 4 in the dQ pass, the choice with which ptxas spills
//   neither.
//
// Other D <= 256, or unaligned rows: the SIMT kernels, a block of 256
// threads per (key tile, kv head, batch row) and per (query tile, head,
// batch row), R x R register tiles of S^T/dP^T and S/dP (rows ty + 16 i,
// columns tx + 16 j), plain fp32 FMAs.  Tiles are 16 R rows: 64 (R = 4) at
// D <= 128, 32 (R = 2) above, where four 64-row fp32 tiles of head_dim 256
// (Q, dO, K, V: 263 KB) would not fit in the 227 KB of shared memory a
// block may hold; at R = 2 they take 137 KB, with room for one block an
// SM.  Each tile's dK, dV (dQ) are summed from zero and added to the running
// sums, so that their rounding grows with the tiles, not the queries (at
// MQA a key's sums run over 8 heads of queries).  A simple kernel: its
// products read shared memory once for each two FMAs, so it is held back
// by shared-memory loads.  They run only at head_dims that are not
// multiples of 8 and on unaligned rows.
//
// Measured (chip_smoke.py phases 3b and 9 and chip_flash_bwd_ablation.py,
// NVIDIA H100 80GB HBM3 at 700.00 W) at the training shape: 0.1032 ms of
// device time (0.1116 through the Python wrapper), 6.9x the 0.0150 ms
// bound; the old SIMT kernels took 0.3245; the forward with the logsumexp
// plus this backward take 0.1389 ms against SDPA's forward plus backward,
// 0.2201.  Without the stagers' global loads it reads 0.0879, without the
// products 0.0781, without the ring stores 0.0922: staging holds it back.
// ptxas: 128 registers at launch (setmaxnreg 56 staging / 200 multiplying,
// 64 / 192 at head_dim 128), no spills.
#include <type_traits>

#include "tc_tf32.cuh"
#include "cluster.cuh"

namespace {

// ---------------------------------------------------------------------------
// SIMT route (head_dim not a multiple of 8, above 128, or unaligned rows):
// fp32 FMAs.
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;

__device__ __forceinline__ bool visible(int qpos, int kpos, int S, int causal, int window) {
  bool ok = qpos < S && kpos < S;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// P from the raw product qk (q . k) and the row's natural logsumexp, as the
// forward computes the scores; under a softcap c, dfac = dA / dS = 1 - (S /
// c)^2 (the caller's 1 stays otherwise)
__device__ __forceinline__ float probs(float qk, float lse, float scale, float softcap,
                                       float& dfac) {
  float x = qk * scale;
  if (softcap > 0.f) {
    const float t = tanhf(x / softcap);
    x = softcap * t;
    dfac = 1.f - t * t;
  }
  return expf(x - lse);
}

// Dvec[(b * H + h) * S + i] = sum_d dO[b, i, h, d] * (O[b, i, h, d] - mu_d): mu
// is row 0 of V at the q head's kv head where v is given (the tensor-core
// routes, which stage V - mu: see their note; their rows are 4-element
// aligned, so a lane reads 4 elements at once: VEC 1 to D <= 128, VEC 2 in
// two runs to 256), else zero (the SIMT route, VEC 0).  A warp a row.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_row_dot_kernel(const T* __restrict__ out, const T* __restrict__ dout,
               const T* __restrict__ v, float* __restrict__ dvec, int B, int S, int H,
               int G, int D, Strides os, Strides ds, Strides vs) {
  const long long rows = (long long)B * H * S;
  const long long r = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  const int i = (int)(r % S), h = (int)((r / S) % H), b = (int)(r / ((long long)S * H));
  const T* orow = out + b * os.b + i * os.s + h * os.h;
  const T* drow = dout + b * ds.b + i * ds.s + h * ds.h;
  const T* mrow = v + b * vs.b + (h / G) * vs.h;   // used by VEC only
  float acc = 0.f;
  using E = typename std::conditional<sizeof(T) == 4, float, uint16_t>::type;
  if constexpr (VEC == 1) {   // D <= 128: 4 elements a lane
    const int d = 4 * lane;
    if (d < D) {
      const float4 o = load4(reinterpret_cast<const E*>(orow) + d, true);
      const float4 m = load4(reinterpret_cast<const E*>(mrow) + d, true);
      const float4 g = load4(reinterpret_cast<const E*>(drow) + d, true);
      acc = (o.x - m.x) * g.x + (o.y - m.y) * g.y + (o.z - m.z) * g.z + (o.w - m.w) * g.w;
    }
  } else if constexpr (VEC == 2) {   // D <= 256: 4 elements a lane, twice
#pragma unroll
    for (int run = 0; run < 2; ++run) {
      const int d = 4 * lane + 128 * run;
      if (d < D) {
        const float4 o = load4(reinterpret_cast<const E*>(orow) + d, true);
        const float4 m = load4(reinterpret_cast<const E*>(mrow) + d, true);
        const float4 g = load4(reinterpret_cast<const E*>(drow) + d, true);
        acc += (o.x - m.x) * g.x + (o.y - m.y) * g.y + (o.z - m.z) * g.z + (o.w - m.w) * g.w;
      }
    }
  } else {
#pragma unroll
    for (int it = 0; it < 8; ++it) {   // D <= 256: every load of the row at once
      const int d = lane + 32 * it;
      if (d < D) acc += to_f(orow[d]) * to_f(drow[d]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dvec[r] = acc;
}

// Words of shared memory of the SIMT kernels: four BT x (D + 1) operand
// tiles, the P^T / dS^T (or dS) tiles, and the tile's LSE and Dvec
__host__ __device__ constexpr int simt_words(int BT, int D, int n_pt) {
  return 4 * BT * (D + 1) + n_pt * BT * (BT + 1) + 2 * BT;
}

// NDK = ceil(D / 16): head_dim columns of an accumulator tile per thread;
// R: rows per thread of a 16 R-row tile.
template <typename T, int NDK, int R>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ dvec,
                           T* __restrict__ dk, T* __restrict__ dv, int S, int H, int Hkv,
                           int D, Strides qs, Strides ks, Strides vs, Strides dos, float scale,
                           int causal, int window, float softcap) {
  constexpr int BQ = 16 * R, BK = 16 * R;
  extern __shared__ float smem[];
  const int DS = D + 1;                       // padded row stride: no bank conflicts
  float* Ks = smem;                           // BK x DS
  float* Vs = Ks + BK * DS;                   // BK x DS
  float* Qs = Vs + BK * DS;                   // BQ x DS
  float* Os = Qs + BQ * DS;                   // BQ x DS (dO)
  float* Ps = Os + BQ * DS;                   // BK x (BQ + 1): P^T
  float* dSs = Ps + BK * (BQ + 1);            // BK x (BQ + 1): dA^T
  float* Ls = dSs + BK * (BQ + 1);            // BQ: LSE of the q tile
  float* Dv = Ls + BQ;                        // BQ: Dvec of the q tile

  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  for (int idx = tid; idx < BK * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const bool in = k0 + r < S;
    Ks[r * DS + d] = in ? to_f(kb[(k0 + r) * ks.s + d]) : 0.f;
    Vs[r * DS + d] = in ? to_f(vb[(k0 + r) * vs.s + d]) : 0.f;
  }

  float dK[R][NDK], dV[R][NDK];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < NDK; ++c) dK[i][c] = dV[i][c] = 0.f;

  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S, k0 + BK - 1 + window) : S;

  for (int h = hk * G; h < (hk + 1) * G; ++h) {
    const T* qb = q + b * qs.b + h * qs.h;
    const T* ob = dout + b * dos.b + h * dos.h;
    const float* lb = lse + ((long long)b * H + h) * S;
    const float* db = dvec + ((long long)b * H + h) * S;
    for (int q0 = q_lo; q0 < q_hi; q0 += BQ) {
      __syncthreads();   // previous tile's Qs/Os/Ps/dSs reads are done (and Ks/Vs loaded)
      for (int idx = tid; idx < BQ * D; idx += kThreads) {
        const int r = idx / D, d = idx % D;
        const bool in = q0 + r < S;
        Qs[r * DS + d] = in ? to_f(qb[(q0 + r) * qs.s + d]) : 0.f;
        Os[r * DS + d] = in ? to_f(ob[(q0 + r) * dos.s + d]) : 0.f;
      }
      if (tid < BQ) {
        const bool in = q0 + tid < S;
        Ls[tid] = in ? lb[q0 + tid] : 0.f;
        Dv[tid] = in ? db[q0 + tid] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T: rows = keys ty + 16 i, columns = queries tx + 16 j
      float st[R][R], dpt[R][R];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) st[i][j] = dpt[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float ka[R], va[R], qa[R], oa[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          ka[i] = Ks[(ty + 16 * i) * DS + d];
          va[i] = Vs[(ty + 16 * i) * DS + d];
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
          qa[j] = Qs[(tx + 16 * j) * DS + d];
          oa[j] = Os[(tx + 16 * j) * DS + d];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) {
            st[i][j] += ka[i] * qa[j];
            dpt[i][j] += va[i] * oa[j];
          }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int kr = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int qc = tx + 16 * j;
          float dfac = 1.f;
          const float p = visible(q0 + qc, k0 + kr, S, causal, window)
                              ? probs(st[i][j], Ls[qc], scale, softcap, dfac) : 0.f;
          Ps[kr * (BQ + 1) + qc] = p;
          dSs[kr * (BQ + 1) + qc] = p * (dpt[i][j] - Dv[qc]) * dfac;
        }
      }
      __syncthreads();

      // the tile's sums from zero, then added to the running ones: the
      // rounding of a running sum grows with the tiles (at MQA, G = 8 q
      // heads x up to S / BQ tiles), not with every query
      float tK[R][NDK], tV[R][NDK];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < NDK; ++c) tK[i][c] = tV[i][c] = 0.f;
      for (int qq = 0; qq < BQ; ++qq) {
        float p[R], ds[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          p[i] = Ps[(ty + 16 * i) * (BQ + 1) + qq];
          ds[i] = dSs[(ty + 16 * i) * (BQ + 1) + qq];
        }
#pragma unroll
        for (int c = 0; c < NDK; ++c) {
          const int d = tx + 16 * c;
          const float o = d < D ? Os[qq * DS + d] : 0.f;
          const float qv = d < D ? Qs[qq * DS + d] : 0.f;
#pragma unroll
          for (int i = 0; i < R; ++i) {
            tV[i][c] += p[i] * o;
            tK[i][c] += ds[i] * qv;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < NDK; ++c) {
          dV[i][c] += tV[i][c];
          dK[i][c] += tK[i][c];
        }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= S) continue;
    const long long row = (((long long)b * S + kpos) * Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < NDK; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        dk[row + d] = from_f<T>(dK[i][c] * scale);
        dv[row + d] = from_f<T>(dV[i][c]);
      }
    }
  }
}

template <typename T, int NDK, int R>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dvec,
                         T* __restrict__ dq, int S, int H, int Hkv, int D, Strides qs,
                         Strides ks, Strides vs, Strides dos, float scale, int causal,
                         int window, float softcap) {
  constexpr int BQ = 16 * R, BK = 16 * R;
  extern __shared__ float smem[];
  const int DS = D + 1;
  float* Qs = smem;                           // BQ x DS
  float* Os = Qs + BQ * DS;                   // BQ x DS (dO)
  float* Ks = Os + BQ * DS;                   // BK x DS
  float* Vs = Ks + BK * DS;                   // BK x DS
  float* dSs = Vs + BK * DS;                  // BQ x (BK + 1): dA
  float* Ls = dSs + BQ * (BK + 1);            // BQ
  float* Dv = Ls + BQ;                        // BQ

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* ob = dout + b * dos.b + h * dos.h;
  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const bool in = q0 + r < S;
    Qs[r * DS + d] = in ? to_f(qb[(q0 + r) * qs.s + d]) : 0.f;
    Os[r * DS + d] = in ? to_f(ob[(q0 + r) * dos.s + d]) : 0.f;
  }
  if (tid < BQ) {
    const bool in = q0 + tid < S;
    Ls[tid] = in ? lse[((long long)b * H + h) * S + q0 + tid] : 0.f;
    Dv[tid] = in ? dvec[((long long)b * H + h) * S + q0 + tid] : 0.f;
  }

  float dQ[R][NDK];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < NDK; ++c) dQ[i][c] = 0.f;

  const int kv_hi = causal ? min(S, q0 + BQ) : S;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BK) {
    __syncthreads();   // previous tile's Ks/dSs reads are done (and Qs/Os loaded)
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const bool in = k0 + r < S;
      Ks[r * DS + d] = in ? to_f(kb[(k0 + r) * ks.s + d]) : 0.f;
      Vs[r * DS + d] = in ? to_f(vb[(k0 + r) * vs.s + d]) : 0.f;
    }
    __syncthreads();

    // S and dP: rows = queries ty + 16 i, columns = keys tx + 16 j
    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qa[R], oa[R], ka[R], va[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qa[i] = Qs[(ty + 16 * i) * DS + d];
        oa[i] = Os[(ty + 16 * i) * DS + d];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        ka[j] = Ks[(tx + 16 * j) * DS + d];
        va[j] = Vs[(tx + 16 * j) * DS + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] += qa[i] * ka[j];
          dp[i][j] += oa[i] * va[j];
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qr = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kc = tx + 16 * j;
        float dfac = 1.f;
        const float p = visible(q0 + qr, k0 + kc, S, causal, window)
                            ? probs(s[i][j], Ls[qr], scale, softcap, dfac) : 0.f;
        dSs[qr * (BK + 1) + kc] = p * (dp[i][j] - Dv[qr]) * dfac;
      }
    }
    __syncthreads();

    float tQ[R][NDK];   // the key tile's sums from zero (as tK, tV above)
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < NDK; ++c) tQ[i][c] = 0.f;
    for (int kk = 0; kk < BK; ++kk) {
      float ds[R];
#pragma unroll
      for (int i = 0; i < R; ++i) ds[i] = dSs[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < NDK; ++c) {
        const int d = tx + 16 * c;
        const float kv = d < D ? Ks[kk * DS + d] : 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i) tQ[i][c] += ds[i] * kv;
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < NDK; ++c) dQ[i][c] += tQ[i][c];
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
    T* row = dq + (((long long)b * S + qpos) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NDK; ++c) {
      const int d = tx + 16 * c;
      if (d < D) row[d] = from_f<T>(dQ[i][c] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core route (head_dim D <= 128, D % 8 == 0): 3xTF32 wgmma.
// ---------------------------------------------------------------------------

constexpr int kTile = 64;               // keys or queries a tile
constexpr int kCh = 32;                 // head_dim columns a chunk
constexpr int kPart = kTile * kCh;      // words of a chunk's hi or lo part
constexpr int kChunk = 2 * kPart;       // words of a chunk: hi, then lo (16 KB)
// a raw chunk as loaded: 64 rows of 32 elements at a pitch of 36 (16-byte
// runs of 8 consecutive rows fall on distinct banks), fp32 or bf16
constexpr int kPitch = 36, kRawWords = kTile * kPitch;

// Shared memory: the block's two resident operands (K and V, or Q and dO),
// DP / 32 chunks each; the 64 x 64 fp32 tile that hands P from one
// consumer warpgroup to the other; a ring of NS chunk slots (at most 6); NR
// raw chunks a stager, in flight from global memory; V's row 0 (mu, below);
// and the block's mbarriers (Bars).
//
// Four warpgroups: two stage (even and odd items), two multiply.  512
// threads are launched at 128 registers each (65536 / 512); the stagers,
// which hold no loads in registers, give registers up to the consumers with
// setmaxnreg (2 STAGE + 2 MUL = 4 x 128), whose running 64 x DP sums (DP / 2
// registers), the A fragments of a 64 x 64 tile (64) and a 64 x 32 chunk
// product (16) must fit.  Chosen by ptxas -v: no spills (at head_dim 128
// the stager needs 64).
template <int DP>
struct BwdTile {
  static constexpr int C = DP / kCh;
  static constexpr int THREADS = 512;
  static constexpr int LAUNCH_REGS = 128;
  static constexpr int STAGE_REGS = DP == 128 ? 64 : 56, MUL_REGS = DP == 128 ? 192 : 200;
  static_assert(2 * STAGE_REGS + 2 * MUL_REGS <= 4 * LAUNCH_REGS,
                "setmaxnreg would wait forever");
  static constexpr int RES_WORDS = 2 * C * kChunk, P_WORDS = kTile * kTile;
  static constexpr int NR = DP == 128 ? 1 : 2;   // raw slots a stager: chunks in flight
  static constexpr int FIT =
      (232448 / 4 - RES_WORDS - P_WORDS - 2 * NR * kRawWords - 128 - 64) / kChunk;
  // even, so that each ring slot has one stager (its parity), and at most 6
  static constexpr int NS = FIT < 6 ? FIT / 2 * 2 : 6;
  static_assert(NS >= C, "a product's chunks must fit in the ring at once");
  static constexpr int RAW_WORDS = RES_WORDS + P_WORDS + NS * kChunk;   // where raw sits
  static constexpr int MU_WORDS = RAW_WORDS + 2 * NR * kRawWords;       // where mu sits
  static constexpr int BAR_WORDS = MU_WORDS + 128;                      // where Bars sit
  static constexpr int SMEM = 4 * BAR_WORDS + 256;
  // what stage() reads: head_dim columns, the ring's place, and the
  // residents' form (TF32 parts in wgmma's layout)
  static constexpr int COLS = DP, RING_WORDS = RES_WORDS + P_WORDS;
  static constexpr bool FP32_RES = false;
};

// ---- mbarriers (their wrappers: cluster.cuh) ---------------------------------
//
// The ring's slots serve two consumer warpgroups in turn, so a slot's
// "filled" signal must say for whom: each consumer warpgroup has its own
// full barrier per slot and tracks its phase there (a bit per slot), and
// waits only for its own items.  A slot has one stager (NS is even, and a
// stager takes every other item).  Every barrier but res expects the 128
// threads of one warpgroup.  A waiter is never more than one phase behind
// or ahead of the barrier it waits on, so a parity names the phase:
//   res          the resident operands staged (both stagers -> consumers)
//   full[w][s]   ring slot s filled for consumer w (its stager -> w)
//   empty[s]     ring slot s read (its consumer -> its stager), which waits
//                for item r - NS before it stores item r
//   pfull/pempty P handed over / its buffer read (consumer 0 <-> 1)
struct Bars {
  uint64_t res, pfull, pempty, full[2][6], empty[6];
};

// One 64 x 32 chunk for the stager: rows row0..row0+63 (zero at rows >= S)
// and head_dim columns 32 ch.. (zero at columns >= cols of the chunk) of
// one operand's (batch row, head) slice; K-major as it lies (head_dim the
// contraction: the B operand of Q K^T-like products, or a resident A), or
// transposed with the 8-step row permutation of store_vt (rows the
// contraction: the B operand of P^T dO, dS^T Q and dS K).
template <typename E>
struct Chunk {
  const E* src;        // row 0, column 32 ch of the slice
  long long rs;        // row stride in elements
  int row0, cols;
  bool trans;
  int to;              // the consumer warpgroup of a ring item
  int mu_col;          // V rows: mu's column of the chunk, subtracted; else -1
};

// cp.async: 4 elements (16 bytes fp32, 8 bytes bf16) from global to shared
// memory without registers, zero-filled where `valid` is false; a thread's
// copies are a group, waited for N groups before the newest
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
               "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A chunk's 64 rows x 32 elements into a raw slot (rows at kPitch
// elements), zero at rows >= S and columns >= cols: 8 threads a row, each 4
// elements.  Needs rows and their base aligned to 4 elements.
template <typename E>
__device__ __forceinline__ void copy_chunk(E* raw, const Chunk<E>& c, int S) {
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int u = it * 128 + threadIdx.x % 128, row = u / 8, col = 4 * (u % 8);
    const bool valid = c.row0 + row < S && col < c.cols;
    cp_async<4 * sizeof(E)>(raw + row * kPitch + col,
                            valid ? c.src + (c.row0 + row) * c.rs + col : c.src, valid);
  }
}

// A raw chunk into registers as store_chunk takes it: rows as load_rows<32>
// hands them over (RowUnit<32>); a transposed chunk as rows too: lane
// 4 m + e of warp w takes row 8 u + p + 2 e and columns 4 m..4 m + 3 in
// pass it, where 2 u + p = 4 it + w is store_vt's 4-slot group, and
// transpose4 then hands lane n column n of those 4 rows.  Both read 8 rows
// of one 16-byte column run per 8 lanes: distinct banks at kPitch.
template <typename E>
__device__ __forceinline__ void read_chunk(float4 (&x)[4], const E* raw, bool trans) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    int row, col;
    if (!trans) {
      const RowUnit<kCh> u(it);
      row = u.n;
      col = 4 * u.c;
    } else {
      const int q = it * 4 + (threadIdx.x / 32) % 4;
      row = 8 * (q / 2) + q % 2 + 2 * (lane % 4);
      col = 4 * (lane / 4);
    }
    x[it] = load4(raw + row * kPitch + col, true);
  }
}

// lanes 4 j..4 j + 3 holding rows e = 0..3 of 4 columns hand lane 4 j + k
// column k of the 4 rows: two exchanges of halves, with lane ^ 2, then ^ 1
__device__ __forceinline__ void transpose4(float4& v) {
  const int e = threadIdx.x % 4;
  float a = e & 2 ? v.x : v.z, b = e & 2 ? v.y : v.w;
  a = __shfl_xor_sync(0xffffffffu, a, 2);
  b = __shfl_xor_sync(0xffffffffu, b, 2);
  if (e & 2) v.x = a, v.y = b;
  else v.z = a, v.w = b;
  a = e & 1 ? v.x : v.y;
  b = e & 1 ? v.z : v.w;
  a = __shfl_xor_sync(0xffffffffu, a, 1);
  b = __shfl_xor_sync(0xffffffffu, b, 1);
  if (e & 1) v.x = a, v.z = b;
  else v.y = a, v.w = b;
}

// x - mu for a chunk of rows as load_rows<32> hands it over (RowUnit<32>)
__device__ __forceinline__ void sub_mu(float4 (&x)[4], const float* mu) {
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const float4 m = *reinterpret_cast<const float4*>(mu + 4 * RowUnit<kCh>(it).c);
    x[it] = make_float4(x[it].x - m.x, x[it].y - m.y, x[it].z - m.z, x[it].w - m.w);
  }
}

__device__ __forceinline__ void store_chunk(const float4 (&x)[4], uint32_t* dst, bool trans) {
  if (!trans) {
    store_rows<kCh>(x, dst, dst + kPart);
    return;
  }
  float t[4][4];
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    float4 v = x[it];
    transpose4(v);
    t[it][0] = v.x;
    t[it][1] = v.y;
    t[it][2] = v.z;
    t[it][3] = v.w;
  }
  store_vt<kCh>(t, dst, dst + kPart);
}

// A resident chunk ch (rows as load_rows<32> hands them over, RowUnit<32>)
// as plain fp32 into a 64 x 128 operand (BwdTileX): row n's 4-word groups
// XOR-swizzled by n % 8, so that these 16-byte stores (8 lanes on 8 rows)
// and the A fragments' loads of ring_product_rs (8 rows x 4 columns a warp)
// fall on distinct banks without padding
__device__ __forceinline__ void store_res(const float4 (&x)[4], float* res, int ch) {
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const RowUnit<kCh> u(it);
    *reinterpret_cast<float4*>(res + u.n * 128 + ((8 * ch + u.c) ^ (u.n % 8)) * 4) = x[it];
  }
}

// Staging warpgroup `which` (0 or 1): chunk items which, which + 2, ... of
// `item`.  The first 2 C are the resident operands; item 2 C + r goes to
// ring slot r % NS once ring item r - NS is read.  A stager's k-th item is
// copied by cp.async into its raw slot k % NR, NR items ahead of its split,
// so that chunks are in flight without holding registers; a slot is copied
// into again once its chunk is in registers.  mu_src: row 0 of V at the
// block's kv head (staged by both stagers, the same values).  Tl: the
// block's shared-memory layout (BwdTile<DP>, or BwdTileX, whose residents
// stay fp32: store_res).
template <typename Tl, typename E, typename ItemFn>
__device__ __forceinline__ void stage(uint32_t* smem, Bars* bars, int which, int n_items,
                                      ItemFn item, const E* mu_src, int S, int D) {
  constexpr int NRES = 2 * Tl::C, NS = Tl::NS, NR = Tl::NR, DP = Tl::COLS;
  uint32_t* ring = smem + Tl::RING_WORDS;
  E* raw = reinterpret_cast<E*>(smem + Tl::RAW_WORDS + which * NR * kRawWords);
  float* mu = reinterpret_cast<float*>(smem + Tl::MU_WORDS);
  auto slot = [&](int k) { return raw + (k % NR) * kRawWords * 4 / sizeof(E); };
  const int mine = (n_items - which + 1) / 2;   // this stager's items
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    if (k < mine) copy_chunk<E>(slot(k), item(which + 2 * k), S);
    cp_async_commit();
  }
  for (int d = threadIdx.x % 128; d < DP; d += 128) mu[d] = d < D ? widen(mu_src[d]) : 0.f;
  for (int k = 0; k < mine; ++k) {
    const int i = which + 2 * k;
    const Chunk<E> c = item(i);   // its flags only: the rest is dead code here
    cp_async_wait<NR - 1>();      // this thread's copies of item i
    bar_sync(1 + which, 128);     // everyone's (and mu)
    float4 x[4];
    read_chunk<E>(x, slot(k), c.trans);
    bar_sync(1 + which, 128);     // the slot is read: copy the next chunk in
    if (k + NR < mine) copy_chunk<E>(slot(k), item(which + 2 * (k + NR)), S);
    cp_async_commit();
    if (c.mu_col >= 0) sub_mu(x, mu + c.mu_col);
    if (i < NRES) {
      if constexpr (Tl::FP32_RES)
        store_res(x, reinterpret_cast<float*>(smem) + (i / Tl::C) * Tl::RES_OP_WORDS, i % Tl::C);
      else
        store_chunk(x, smem + i * kChunk, c.trans);
      if (i >= NRES - 2) {   // this stager's last resident item
        fence_proxy_async();
        mbar_arrive(&bars->res);
      }
    } else {
      const int r = i - NRES, s = r % NS;
      if (r >= NS) mbar_wait(&bars->empty[s], (r / NS - 1) & 1);
      store_chunk(x, ring + s * kChunk, c.trans);
      fence_proxy_async();   // the generic stores, seen by wgmma's reads
      mbar_arrive(&bars->full[c.to][s]);
    }
  }
}

// acc (64 x 64) = A B^T from zero on one warpgroup, 3xTF32 (lo*hi + hi*lo +
// hi*hi each 8-deep step): A (64 rows x DP) resident as C chunks from `a`,
// B (64 rows x DP) as C ring chunks; both K-major, core matrices 128 bytes
// apart along head_dim and 1024 bytes along the rows.  One branch-free
// batch from fence to wait.
template <int C>
__device__ __forceinline__ void ss_product(float (&acc)[32], const uint32_t* a,
                                           const uint32_t* const (&b)[C]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    acc[i] = 0.f;
    fence_reg(acc[i]);
  }
  wgmma_fence();
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    // the resident operand's descriptors, opaque: else the compiler keeps
    // every step's in registers across the tile loop
    const uint64_t dah = opaque(wgmma_desc(a + ch * kChunk, 128, 1024));
    const uint64_t dal = opaque(wgmma_desc(a + ch * kChunk + kPart, 128, 1024));
    const uint64_t dbh = wgmma_desc(b[ch], 128, 1024), dbl = wgmma_desc(b[ch] + kPart, 128, 1024);
#pragma unroll
    for (int u = 0; u < kCh / 8; ++u) {
      wgmma_ss_n64(acc, dal + 16 * u, dbh + 16 * u, ch > 0 || u > 0);
      wgmma_ss_n64(acc, dah + 16 * u, dbl + 16 * u, 1);
      wgmma_ss_n64(acc, dah + 16 * u, dbh + 16 * u, 1);
    }
  }
  wgmma_commit();
  wgmma_wait0();
#pragma unroll
  for (int i = 0; i < 32; ++i) fence_reg(acc[i]);
}

// A 64 x 64 accumulator's values as the A fragments of its 8 column steps,
// split into TF32 parts: a[0] = (row g, slot t) = column 8 u + 2 t = v[4 u],
// a[1] = (row g + 8, slot t) = v[4 u + 2], a[2] = (row g, slot t + 4) =
// column 8 u + 2 t + 1 = v[4 u + 1], a[3] = v[4 u + 3]; the B operand is
// staged with the same permutation of its rows (store_vt)
__device__ __forceinline__ void to_frags(const float (&v)[32], uint32_t (&h)[8][4],
                                         uint32_t (&l)[8][4]) {
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int a = e == 1 ? 2 : e == 2 ? 1 : e;
      split(v[4 * u + e], h[u][a], l[u][a]);
    }
}

// Wait for ring item r of consumer warpgroup w, flipping w's phase bit of
// its slot; returns the slot
template <int NS>
__device__ __forceinline__ int take(Bars* bars, int w, int r, uint32_t& phase) {
  const int s = r % NS;
  mbar_wait(&bars->full[w][s], (phase >> s) & 1);
  phase ^= 1u << s;
  return s;
}

// acc += X C, chunk by chunk of C's columns: X (64 x 64) as A fragments,
// C's 64 rows staged transposed in ring items first.. (one a 32-column
// chunk); each chunk's product is summed from zero and added in fp32, since
// the tensor core truncates its sums
template <int DP, int NS = BwdTile<DP>::NS>
__device__ __forceinline__ void frag_product(float (&acc)[DP / 2], uint32_t (&h)[8][4],
                                             uint32_t (&l)[8][4], const uint32_t* ring,
                                             Bars* bars, int w, int first, uint32_t& phase) {
#pragma unroll
  for (int n = 0; n < DP / kCh; ++n) {
    const int s = take<NS>(bars, w, first + n, phase);
    float tmp[kCh / 2];
    pv_chunk<kCh, true>(tmp, h, l, ring + s * kChunk, ring + s * kChunk + kPart);
    mbar_arrive(&bars->empty[s]);
#pragma unroll
    for (int i = 0; i < kCh / 2; ++i) acc[n * kCh / 2 + i] += tmp[i];
  }
}

// The first product of a tile on consumer warpgroup w: the C ring items
// from `first` (its B operand) against the resident operand `res`
template <int DP>
__device__ __forceinline__ void ring_product(float (&acc)[32], const uint32_t* res,
                                             const uint32_t* ring, Bars* bars, int w, int first,
                                             uint32_t& phase) {
  constexpr int C = BwdTile<DP>::C, NS = BwdTile<DP>::NS;
  const uint32_t* b[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) b[ch] = ring + take<NS>(bars, w, first + ch, phase) * kChunk;
  ss_product<C>(acc, res, b);
#pragma unroll
  for (int ch = 0; ch < C; ++ch) mbar_arrive(&bars->empty[(first + ch) % NS]);
}

// A consumer warpgroup's running 64 x DP sums (acc[4 i + e]: row r0 + 8 (e
// / 2), column 8 i + 2 t + e % 2) times mul, into rows < S of a (B, S, Hx,
// D) output at element base + row * rstride
template <int DP>
__device__ __forceinline__ void store_acc(const float (&acc)[DP / 2], void* out, int bf16,
                                          long long base, long long rstride, int r0, int S,
                                          int D, float mul) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int col = 8 * i + 2 * t;
    if (col >= D) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      if (r >= S) continue;
      const float x0 = acc[4 * i + 2 * half] * mul, x1 = acc[4 * i + 2 * half + 1] * mul;
      const long long idx = base + r * rstride + col;
      if (bf16)
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + idx) =
            __floats2bfloat162_rn(x0, x1);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) = make_float2(x0, x1);
    }
  }
}

// a (query, key) tile of 64 x 64 with every pair visible
__device__ __forceinline__ bool tile_full(int q0, int k0, int S, int causal, int window) {
  return q0 + kTile - 1 < S && k0 + kTile - 1 < S && (!causal || k0 + kTile - 1 <= q0) &&
         (window <= 0 || k0 > q0 + kTile - 1 - window);
}

// The P hand-over buffer: thread j of either consumer warpgroup holds the
// same accumulator positions, so value i of thread j sits at word 128 i + j
// (conflict-free).  Tile n's P goes in once tile n - 1's is read.
__device__ __forceinline__ void put_p(float* pbuf, Bars* bars, const float (&p)[32], int n) {
  if (n > 0) mbar_wait(&bars->pempty, (n - 1) & 1);
#pragma unroll
  for (int i = 0; i < 32; ++i) pbuf[128 * i + threadIdx.x % 128] = p[i];
  mbar_arrive(&bars->pfull);
}

// Consumer 0's tile under a softcap c: the raw products in x become P (S =
// c tanh(A / c) in base 2, as the forward computes it), and the hand-over
// buffer gets P (1 - (S / c)^2), so that consumer 1's dS is dA.
// visible(i) says whether accumulator position i is a visible pair, rv(i)
// is its row's logsumexp in base 2.
template <typename Vis, typename Row>
__device__ __forceinline__ void softcap_p(float (&x)[32], float* pbuf, Bars* bars, int n,
                                          float scale, float softcap, Vis visible_at,
                                          Row rv) {
  const float softcap_l2e = softcap * kLog2e;
  if (n > 0) mbar_wait(&bars->pempty, (n - 1) & 1);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float t = tanhf(x[i] * scale / softcap);
    const float p = visible_at(i) ? ex2(softcap_l2e * t - rv(i)) : 0.f;
    pbuf[128 * i + threadIdx.x % 128] = p * (1.f - t * t);
    x[i] = p;
  }
  mbar_arrive(&bars->pfull);
}

// The block's barriers, set up by one thread before the warpgroups split
__device__ __forceinline__ Bars* init_bars(uint32_t* at) {
  Bars* bars = reinterpret_cast<Bars*>(at);
  if (threadIdx.x == 0) {
    mbar_init(&bars->res, 256);
    mbar_init(&bars->pfull, 128);
    mbar_init(&bars->pempty, 128);
    for (int s = 0; s < 6; ++s) {
      mbar_init(&bars->full[0][s], 128);
      mbar_init(&bars->full[1][s], 128);
      mbar_init(&bars->empty[s], 128);
    }
  }
  __syncthreads();
  return bars;
}

// dK and dV of one 64-key tile of one (batch row, kv head): the block
// loops over the q heads of the GQA group and the 64-query tiles that see
// its keys.  Consumer warpgroup 0: S^T = K Q^T, P^T (handed to warpgroup 1),
// dV += P^T dO; warpgroup 1: dP^T = V dO^T, dS^T = P^T (dP^T - Dvec),
// dK += dS^T Q.  Rows are keys and columns queries, so that P^T and dS^T
// are A fragments as they stand.  Ring items of a tile: Q (rows), dO
// (rows), dO (transposed), Q (transposed), C chunks each.
template <int DP, bool CAP>
__global__ void __launch_bounds__(BwdTile<DP>::THREADS, 1)
flash_bwd_dkdv_wgmma_kernel(const void* __restrict__ q, const void* __restrict__ k,
                            const void* __restrict__ v, const void* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ dvec,
                            void* __restrict__ dk, void* __restrict__ dv, int B, int S, int H,
                            int Hkv, int D, Strides qs, Strides ks, Strides vs, Strides dos,
                            float scale, int causal, int window, float softcap, int bf16) {
  using Tl = BwdTile<DP>;
  constexpr int C = Tl::C;
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(bwd_smem);
  Bars* bars = init_bars(smem + Tl::BAR_WORDS);
  // block -> (key tile, kv head, batch row), heads fastest; causal: the
  // first key tiles see the most queries and run first
  const int hb = blockIdx.x % (Hkv * B), kt = blockIdx.x / (Hkv * B);
  const int hk = hb % Hkv, b = hb / Hkv, G = H / Hkv;
  const int k0 = kt * kTile;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S, k0 + kTile - 1 + window) : S;
  const int nq = (q_hi - q_lo + kTile - 1) / kTile;   // query tiles a q head
  const int n_tiles = G * nq, n_ring = n_tiles * 4 * C;

  if (threadIdx.x < 256) {   // the stagers
    setmaxnreg_dec<Tl::STAGE_REGS>();
    auto run = [&](auto zero) {
      using E = decltype(zero);
      const E* kp = static_cast<const E*>(k) + b * ks.b + hk * ks.h;
      const E* vp = static_cast<const E*>(v) + b * vs.b + hk * vs.h;
      const E* qp = static_cast<const E*>(q) + b * qs.b;
      const E* dp = static_cast<const E*>(dout) + b * dos.b;
      auto item = [&](int i) {
        if (i < 2 * C) {
          const int ch = i % C;
          return i < C ? Chunk<E>{kp + kCh * ch, ks.s, k0, D - kCh * ch, false, 0, -1}
                       : Chunk<E>{vp + kCh * ch, vs.s, k0, D - kCh * ch, false, 1, kCh * ch};
        }
        // Q rows (to 0), dO rows (1), dO transposed (0), Q transposed (1)
        const int r = i - 2 * C, tile = r / (4 * C), kind = (r / C) % 4, ch = r % C;
        const int h = hk * G + tile / nq, q0 = q_lo + (tile % nq) * kTile;
        const bool is_q = kind == 0 || kind == 3;
        const E* src = is_q ? qp + h * qs.h : dp + h * dos.h;
        return Chunk<E>{src + kCh * ch, is_q ? qs.s : dos.s, q0, D - kCh * ch, kind >= 2,
                        kind & 1, -1};
      };
      stage<Tl, E>(smem, bars, threadIdx.x / 128, 2 * C + n_ring, item, vp, S, D);
    };
    if (bf16) run(uint16_t{});
    else run(0.f);
    return;
  }

  setmaxnreg_inc<Tl::MUL_REGS>();
  const int w = threadIdx.x / 128 - 2;   // consumer warpgroup
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, t = lane % 4;
  const int kr0 = k0 + 16 * warp + lane / 4, kr1 = kr0 + 8;   // this thread's keys
  const uint32_t* res = smem + w * C * kChunk;                 // K (w = 0) or V (w = 1)
  float* pbuf = reinterpret_cast<float*>(smem + Tl::RES_WORDS);
  const uint32_t* ring = smem + Tl::RES_WORDS + Tl::P_WORDS;
  const float scale_l2e = scale * kLog2e;
  float acc[DP / 2];   // dV (w = 0) or dK / scale (w = 1)
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float x[32];         // S^T then P^T (w = 0); dP^T then dS^T (w = 1)
  uint32_t fh[8][4], fl[8][4];
  uint32_t phase = 0;  // this warpgroup's full-barrier phase of each ring slot

  mbar_wait(&bars->res, 0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int h = hk * G + tile / nq, q0 = q_lo + (tile % nq) * kTile;
    const int first = tile * 4 * C;   // ring index of the tile's first item
    // this thread's 16 query columns q0 + 8 i + 2 t + j: the logsumexp in
    // base 2 (w = 0) or Dvec (w = 1)
    const float* rowv = (w == 0 ? lse : dvec) + ((long long)b * H + h) * S;
    float rv[16];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qq = q0 + 8 * i + 2 * t + j;
        rv[2 * i + j] = qq < S ? rowv[qq] * (w == 0 ? kLog2e : 1.f) : 0.f;
      }
    ring_product<DP>(x, res, ring, bars, w, first + w * C, phase);
    if (CAP && w == 0) {
      const bool full = tile_full(q0, k0, S, causal, window);
      softcap_p(
          x, pbuf, bars, tile, scale, softcap,
          [&](int i) {
            return full || visible(q0 + 8 * (i / 4) + 2 * t + (i & 1), i % 4 < 2 ? kr0 : kr1, S,
                                   causal, window);
          },
          [&](int i) { return rv[2 * (i / 4) + (i & 1)]; });
    } else if (w == 0) {
      const bool full = tile_full(q0, k0, S, causal, window);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = q0 + 8 * i + 2 * t + (e & 1), kpos = e < 2 ? kr0 : kr1;
          const bool ok = full || visible(qpos, kpos, S, causal, window);
          x[4 * i + e] = ok ? ex2(x[4 * i + e] * scale_l2e - rv[2 * i + (e & 1)]) : 0.f;
        }
      put_p(pbuf, bars, x, tile);
    } else {
      mbar_wait(&bars->pfull, tile & 1);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        x[i] = pbuf[128 * i + threadIdx.x % 128] * (x[i] - rv[2 * (i / 4) + (i & 1)]);
      mbar_arrive(&bars->pempty);
    }
    to_frags(x, fh, fl);
    frag_product<DP>(acc, fh, fl, ring, bars, w, first + (2 + w) * C, phase);
  }

  const long long rstride = (long long)Hkv * D, base = (long long)b * S * rstride + hk * D;
  store_acc<DP>(acc, w == 0 ? dv : dk, bf16, base, rstride, kr0, S, D, w == 0 ? 1.f : scale);
}

// dQ of one 64-query tile of one (batch row, q head): the block loops over
// the key tiles its queries see.  Consumer warpgroup 0: S = Q K^T, P
// (handed to warpgroup 1); warpgroup 1: dP = dO V^T, dS = P (dP - Dvec),
// dQ += dS K.  Ring items of a key tile: K (rows), V (rows), K
// (transposed), C chunks each.
template <int DP, bool CAP>
__global__ void __launch_bounds__(BwdTile<DP>::THREADS, 1)
flash_bwd_dq_wgmma_kernel(const void* __restrict__ q, const void* __restrict__ k,
                          const void* __restrict__ v, const void* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dvec,
                          void* __restrict__ dq, int B, int S, int H, int Hkv, int D, Strides qs,
                          Strides ks, Strides vs, Strides dos, float scale, int causal,
                          int window, float softcap, int bf16) {
  using Tl = BwdTile<DP>;
  constexpr int C = Tl::C;
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(bwd_smem);
  Bars* bars = init_bars(smem + Tl::BAR_WORDS);
  // block -> (query tile, head, batch row), heads fastest; causal: the
  // longest query tiles (the most key tiles) first
  const int nqt = (S + kTile - 1) / kTile;
  const int hb = blockIdx.x % (H * B), qt_rev = blockIdx.x / (H * B);
  const int h = hb % H, b = hb / H, hk = h / (H / Hkv);
  const int q0 = (causal ? nqt - 1 - qt_rev : qt_rev) * kTile;
  const int kv_hi = causal ? min(S, q0 + kTile) : S;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int nt = (kv_hi - kv_lo + kTile - 1) / kTile, n_ring = nt * 3 * C;

  if (threadIdx.x < 256) {   // the stagers
    setmaxnreg_dec<Tl::STAGE_REGS>();
    auto run = [&](auto zero) {
      using E = decltype(zero);
      const E* qp = static_cast<const E*>(q) + b * qs.b + h * qs.h;
      const E* dp = static_cast<const E*>(dout) + b * dos.b + h * dos.h;
      const E* kp = static_cast<const E*>(k) + b * ks.b + hk * ks.h;
      const E* vp = static_cast<const E*>(v) + b * vs.b + hk * vs.h;
      auto item = [&](int i) {
        if (i < 2 * C) {
          const int ch = i % C;
          return i < C ? Chunk<E>{qp + kCh * ch, qs.s, q0, D - kCh * ch, false, 0, -1}
                       : Chunk<E>{dp + kCh * ch, dos.s, q0, D - kCh * ch, false, 1, -1};
        }
        // K rows (to 0), V rows (1), K transposed (1)
        const int r = i - 2 * C, j = r / (3 * C), kind = (r / C) % 3, ch = r % C;
        const int k0 = kv_lo + j * kTile;
        return kind == 1 ? Chunk<E>{vp + kCh * ch, vs.s, k0, D - kCh * ch, false, 1, kCh * ch}
                         : Chunk<E>{kp + kCh * ch, ks.s, k0, D - kCh * ch, kind == 2, kind / 2,
                                    -1};
      };
      stage<Tl, E>(smem, bars, threadIdx.x / 128, 2 * C + n_ring, item, vp, S, D);
    };
    if (bf16) run(uint16_t{});
    else run(0.f);
    return;
  }

  setmaxnreg_inc<Tl::MUL_REGS>();
  const int w = threadIdx.x / 128 - 2;   // consumer warpgroup
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, t = lane % 4;
  const int qr0 = q0 + 16 * warp + lane / 4, qr1 = qr0 + 8;   // this thread's queries
  const uint32_t* res = smem + w * C * kChunk;                 // Q (w = 0) or dO (w = 1)
  float* pbuf = reinterpret_cast<float*>(smem + Tl::RES_WORDS);
  const uint32_t* ring = smem + Tl::RES_WORDS + Tl::P_WORDS;
  const float scale_l2e = scale * kLog2e;
  // the logsumexp in base 2 (w = 0) or Dvec (w = 1) of this thread's rows
  const float* rowv = (w == 0 ? lse : dvec) + ((long long)b * H + h) * S;
  const float mul = w == 0 ? kLog2e : 1.f;
  const float rv0 = qr0 < S ? rowv[qr0] * mul : 0.f, rv1 = qr1 < S ? rowv[qr1] * mul : 0.f;
  float acc[DP / 2];   // dQ / scale (w = 1)
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float x[32];         // S then P (w = 0); dP then dS (w = 1)
  uint32_t fh[8][4], fl[8][4];
  uint32_t phase = 0;  // this warpgroup's full-barrier phase of each ring slot

  mbar_wait(&bars->res, 0);
  for (int j = 0; j < nt; ++j) {
    const int k0 = kv_lo + j * kTile, first = j * 3 * C;
    ring_product<DP>(x, res, ring, bars, w, first + w * C, phase);
    if (CAP && w == 0) {
      const bool full = tile_full(q0, k0, S, causal, window);
      softcap_p(
          x, pbuf, bars, j, scale, softcap,
          [&](int i) {
            return full || visible(i % 4 < 2 ? qr0 : qr1, k0 + 8 * (i / 4) + 2 * t + (i & 1), S,
                                   causal, window);
          },
          [&](int i) { return i % 4 < 2 ? rv0 : rv1; });
      continue;
    }
    if (w == 0) {
      const bool full = tile_full(q0, k0, S, causal, window);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * i + 2 * t + (e & 1), qpos = e < 2 ? qr0 : qr1;
          const bool ok = full || visible(qpos, kpos, S, causal, window);
          x[4 * i + e] = ok ? ex2(x[4 * i + e] * scale_l2e - (e < 2 ? rv0 : rv1)) : 0.f;
        }
      put_p(pbuf, bars, x, j);
      continue;
    }
    mbar_wait(&bars->pfull, j & 1);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      x[i] = pbuf[128 * i + threadIdx.x % 128] * (x[i] - (i % 4 < 2 ? rv0 : rv1));
    mbar_arrive(&bars->pempty);
    to_frags(x, fh, fl);
    frag_product<DP>(acc, fh, fl, ring, bars, w, first + 2 * C, phase);
  }

  if (w == 1) {
    const long long rstride = (long long)H * D, base = (long long)b * S * rstride + h * D;
    store_acc<DP>(acc, dq, bf16, base, rstride, qr0, S, D, scale);
  }
}

template <int DP, bool CAP>
int launch_wgmma(int dtype, const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* dvec, void* dq, void* dk, void* dv, int B, int S,
                 int H, int Hkv, int D, Strides qs, Strides ks, Strides vs, Strides dos,
                 float scale, int causal, int window, float softcap, cudaStream_t st) {
  using Tl = BwdTile<DP>;
  auto kv_kernel = flash_bwd_dkdv_wgmma_kernel<DP, CAP>;
  auto q_kernel = flash_bwd_dq_wgmma_kernel<DP, CAP>;
  cudaError_t err;
  const void* kernels[2] = {reinterpret_cast<const void*>(kv_kernel),
                            reinterpret_cast<const void*>(q_kernel)};
  for (const void* kern : kernels) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::SMEM);
    if (err != cudaSuccess) return (int)err;
    // the warpgroups' setmaxnreg counts assume this launch count: refuse
    // rather than launch a block that would wait forever
    cudaFuncAttributes attr;
    if ((err = cudaFuncGetAttributes(&attr, kern)) != cudaSuccess) return (int)err;
    if (attr.numRegs != Tl::LAUNCH_REGS) return (int)cudaErrorLaunchOutOfResources;
  }
  const int nt = (S + kTile - 1) / kTile;
  kv_kernel<<<nt * Hkv * B, Tl::THREADS, Tl::SMEM, st>>>(q, k, v, dout, lse, dvec, dk, dv, B, S,
                                                         H, Hkv, D, qs, ks, vs, dos, scale,
                                                         causal, window, softcap, dtype == 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  q_kernel<<<nt * H * B, Tl::THREADS, Tl::SMEM, st>>>(q, k, v, dout, lse, dvec, dq, B, S, H, Hkv,
                                                      D, qs, ks, vs, dos, scale, causal, window,
                                                      softcap, dtype == 1);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core route at 128 < D <= 256 (D % 8 == 0): a cluster of two CTAs,
// each the DP = 128 block on its half of head_dim.
// ---------------------------------------------------------------------------

// Shared memory of one CTA of the pair (128 head_dim columns): the two
// resident operands as plain fp32, 64 x 128 each (store_res), split into
// TF32 parts in registers where they are used (ring_product_rs); the P
// hand-over tile; the two exchange tiles, where the peer's partial S (or
// S^T) and dP (or dP^T) land; the ring (NS = 4); two raw slots a stager (NR
// = 2: chunks in flight, which the ring's other two slots would not buy);
// mu and the barriers.  Registers: 56 a stager thread, 200 a consumer
// thread, whose running sums (64 x 128 in the dK/dV pass, 64 x 64 in the
// dQ pass), chunk sum (32) and one chunk's A fragments (32) must fit; chosen
// by ptxas -v: no spills.
struct BwdTileX {
  static constexpr int COLS = 128, C = COLS / kCh;
  static constexpr int THREADS = 512;
  static constexpr int LAUNCH_REGS = 128, STAGE_REGS = 56, MUL_REGS = 200;
  static_assert(2 * STAGE_REGS + 2 * MUL_REGS <= 4 * LAUNCH_REGS,
                "setmaxnreg would wait forever");
  static constexpr bool FP32_RES = true;
  static constexpr int RES_OP_WORDS = kTile * COLS, RES_WORDS = 2 * RES_OP_WORDS;
  static constexpr int P_WORDS = kTile * kTile, X_WORDS = 2 * kTile * kTile;
  static constexpr int NR = 2;
  static constexpr int FIT = (232448 / 4 - RES_WORDS - P_WORDS - X_WORDS - 2 * NR * kRawWords -
                              128 - 64) / kChunk;
  static constexpr int NS = FIT < 6 ? FIT / 2 * 2 : 6;
  static_assert(NS >= C, "a product's chunks must fit in the ring at once");
  static constexpr int X_OFF = RES_WORDS + P_WORDS;                      // exchange tiles
  static constexpr int RING_WORDS = X_OFF + X_WORDS;                     // the ring
  static constexpr int RAW_WORDS = RING_WORDS + NS * kChunk;
  static constexpr int MU_WORDS = RAW_WORDS + 2 * NR * kRawWords;
  static constexpr int BAR_WORDS = MU_WORDS + 128;                      // Bars, then XBars
  static constexpr int XBAR_WORDS = BAR_WORDS + 44;
  static constexpr int SMEM = 4 * BAR_WORDS + 256;
};
static_assert(sizeof(Bars) <= 4 * 44, "XBars would overlap Bars");

// Both CTAs' barriers, set up before the warpgroups split: the cluster
// barrier also tells each CTA that its peer's are ready for remote arrivals
__device__ __forceinline__ Bars* init_bars_cluster(uint32_t* smem, XBars** xb) {
  using Tl = BwdTileX;
  Bars* bars = reinterpret_cast<Bars*>(smem + Tl::BAR_WORDS);
  *xb = reinterpret_cast<XBars*>(smem + Tl::XBAR_WORDS);
  if (threadIdx.x == 0) {
    mbar_init(&bars->res, 256);
    mbar_init(&bars->pfull, 128);
    mbar_init(&bars->pempty, 128);
    for (int s = 0; s < 6; ++s) {
      mbar_init(&bars->full[0][s], 128);
      mbar_init(&bars->full[1][s], 128);
      mbar_init(&bars->empty[s], 128);
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(&(*xb)->xfull[w], 128);
      mbar_init(&(*xb)->xfree[w], 128);
    }
  }
  cluster_bars_ready();
  return bars;
}

// acc (64 x 64) = A B^T on consumer warpgroup w, 3xTF32 in ss_product's
// order (lo*hi, hi*lo, hi*hi each 8-deep step): A (64 rows x 128) the fp32
// resident `a` (store_res's layout), split into TF32 parts in registers as
// wgmma's A fragments, STEPS k-steps at a time into h and l (one batch of
// wgmmas each); B (64 rows x 128) the C = 4 ring items from `first`, K-major
// as ss_product reads them, each waited for just before its chunk and
// released just after it.  Each 32-column chunk's product is summed from
// zero and added in fp32: the tensor core truncates its sums, and over 256
// columns of one-sign data (q . k ~ 64) one accumulator's drift reaches P,
// and dV through it.  STEPS = 4 (a chunk a batch) or 2 (16 registers fewer
// for h and l, two batches a chunk): ptxas spills neither kernel with the
// choice each makes.
template <int STEPS>
__device__ __forceinline__ void ring_product_rs(float (&acc)[32], const float* a,
                                                const uint32_t* ring, Bars* bars, int w,
                                                int first, uint32_t& phase, uint32_t (&h)[8][4],
                                                uint32_t (&l)[8][4]) {
  static_assert(STEPS == 2 || STEPS == 4, "a chunk is 4 k-steps");
  constexpr int NS = BwdTileX::NS;
  const int lane = threadIdx.x % 32, g = lane / 4;
  // row g of this warp's 16 (row g + 8: 8 * 128 words on), column t
  const float* row = a + (16 * ((threadIdx.x / 32) % 4) + g) * 128 + lane % 4;
  // the A fragments of k-steps kk0.. kk0 + STEPS - 1 (columns 8 kk + t and
  // 8 kk + t + 4)
  auto frags = [&](int kk0) {
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      const int kk = kk0 + u;
      const int c0 = ((2 * kk) ^ g) * 4, c1 = ((2 * kk + 1) ^ g) * 4;
      split(row[c0], h[u][0], l[u][0]);
      split(row[8 * 128 + c0], h[u][1], l[u][1]);
      split(row[c1], h[u][2], l[u][2]);
      split(row[8 * 128 + c1], h[u][3], l[u][3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        fence_reg(h[u][e]);
        fence_reg(l[u][e]);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int ch = 0; ch < BwdTileX::C; ++ch) {
    if constexpr (STEPS == 4) frags(4 * ch);
    float part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      part[i] = 0.f;
      fence_reg(part[i]);
    }
    const int s = take<NS>(bars, w, first + ch, phase);
    const uint32_t* bc = ring + s * kChunk;
    const uint64_t dbh = wgmma_desc(bc, 128, 1024), dbl = wgmma_desc(bc + kPart, 128, 1024);
#pragma unroll
    for (int hb = 0; hb < 4 / STEPS; ++hb) {
      if constexpr (STEPS != 4) frags(4 * ch + STEPS * hb);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < STEPS; ++u) {
        const int st = STEPS * hb + u;
        wgmma_rs_n64(part, l[u], dbh + 16 * st, st > 0);
        wgmma_rs_n64(part, h[u], dbl + 16 * st, 1);
        wgmma_rs_n64(part, h[u], dbh + 16 * st, 1);
      }
      wgmma_commit();
      wgmma_wait0();
      if constexpr (STEPS == 4) mbar_arrive(&bars->empty[s]);
#pragma unroll
      for (int u = 0; u < STEPS; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          fence_reg(h[u][e]);
          fence_reg(l[u][e]);
        }
    }
    if constexpr (STEPS != 4) mbar_arrive(&bars->empty[s]);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      fence_reg(part[i]);
      acc[i] += part[i];
    }
  }
}

// dK and dV of one 64-key tile of one (batch row, kv head), on the head_dim
// columns 128 rank.. of cluster CTA `rank`; the q heads of the GQA group
// are split into g parts (one cluster each): part p sums heads p G / g ..
// (p + 1) G / g - 1 and, where g > 1, writes fp32 partials (dK already
// scaled) to parts[p] (dK) and parts[g + p] (dV), each (B, S, Hkv, D), for
// flash_bwd_sum_parts_kernel.  Otherwise as flash_bwd_dkdv_wgmma_kernel:
// consumer 0 S^T, P^T and dV; consumer 1 dP^T, dS^T and dK, each contracting
// product exchanged with the peer.
template <bool CAP>
__global__ void __launch_bounds__(BwdTileX::THREADS, 1)
flash_bwd_dkdv_cluster_kernel(const void* __restrict__ q, const void* __restrict__ k,
                              const void* __restrict__ v, const void* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ dvec,
                              void* __restrict__ dk, void* __restrict__ dv,
                              float* __restrict__ parts, int g, int B, int S, int H, int Hkv,
                              int D, Strides qs, Strides ks, Strides vs, Strides dos,
                              float scale, int causal, int window, float softcap, int bf16) {
  using Tl = BwdTileX;
  constexpr int C = Tl::C;
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(bwd_smem);
  XBars* xb;
  Bars* bars = init_bars_cluster(smem, &xb);
  const uint32_t rank = cluster_rank();
  const int col0 = 128 * (int)rank, Dr = min(128, D - col0);   // this CTA's columns
  // cluster -> (part, kv head, batch row, key tile), parts and heads
  // fastest; causal: the first key tiles see the most queries and run first
  int cl = blockIdx.x / 2;
  const int part = cl % g;
  cl /= g;
  const int hb = cl % (Hkv * B), kt = cl / (Hkv * B);
  const int hk = hb % Hkv, b = hb / Hkv, Gp = H / Hkv / g;
  const int h0 = hk * (H / Hkv) + part * Gp;   // the part's first q head
  const int k0 = kt * kTile;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S, k0 + kTile - 1 + window) : S;
  const int nq = (q_hi - q_lo + kTile - 1) / kTile;   // query tiles a q head
  const int n_tiles = Gp * nq, n_ring = n_tiles * 4 * C;

  if (threadIdx.x < 256) {   // the stagers
    setmaxnreg_dec<Tl::STAGE_REGS>();
    auto run = [&](auto zero) {
      using E = decltype(zero);
      const E* kp = static_cast<const E*>(k) + b * ks.b + hk * ks.h + col0;
      const E* vp = static_cast<const E*>(v) + b * vs.b + hk * vs.h + col0;
      const E* qp = static_cast<const E*>(q) + b * qs.b + col0;
      const E* dp = static_cast<const E*>(dout) + b * dos.b + col0;
      auto item = [&](int i) {
        if (i < 2 * C) {
          const int ch = i % C;
          return i < C ? Chunk<E>{kp + kCh * ch, ks.s, k0, Dr - kCh * ch, false, 0, -1}
                       : Chunk<E>{vp + kCh * ch, vs.s, k0, Dr - kCh * ch, false, 1, kCh * ch};
        }
        // Q rows (to 0), dO rows (1), dO transposed (0), Q transposed (1)
        const int r = i - 2 * C, tile = r / (4 * C), kind = (r / C) % 4, ch = r % C;
        const int h = h0 + tile / nq, q0 = q_lo + (tile % nq) * kTile;
        const bool is_q = kind == 0 || kind == 3;
        const E* src = is_q ? qp + h * qs.h : dp + h * dos.h;
        return Chunk<E>{src + kCh * ch, is_q ? qs.s : dos.s, q0, Dr - kCh * ch, kind >= 2,
                        kind & 1, -1};
      };
      stage<Tl, E>(smem, bars, threadIdx.x / 128, 2 * C + n_ring, item, vp, S, Dr);
    };
    if (bf16) run(uint16_t{});
    else run(0.f);
    return;
  }

  setmaxnreg_inc<Tl::MUL_REGS>();
  const int w = threadIdx.x / 128 - 2;   // consumer warpgroup
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, t = lane % 4;
  const int kr0 = k0 + 16 * warp + lane / 4, kr1 = kr0 + 8;   // this thread's keys
  const float* res = reinterpret_cast<const float*>(smem) + w * Tl::RES_OP_WORDS;  // K or V
  float* pbuf = reinterpret_cast<float*>(smem + Tl::RES_WORDS);
  float* xt = reinterpret_cast<float*>(smem + Tl::X_OFF) + w * kTile * kTile;
  const uint32_t* ring = smem + Tl::RING_WORDS;
  const float scale_l2e = scale * kLog2e;
  float acc[64];       // dV (w = 0) or dK / scale (w = 1), this CTA's columns
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float x[32];         // S^T then P^T (w = 0); dP^T then dS^T (w = 1)
  uint32_t fh[8][4], fl[8][4];
  uint32_t phase = 0;  // this warpgroup's full-barrier phase of each ring slot

  mbar_wait(&bars->res, 0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int h = h0 + tile / nq, q0 = q_lo + (tile % nq) * kTile;
    const int first = tile * 4 * C;   // ring index of the tile's first item
    ring_product_rs<2>(x, res, ring, bars, w, first + w * C, phase, fh, fl);
    // this thread's 16 query columns: the logsumexp in base 2 (w = 0) or
    // Dvec (w = 1), loaded after the product (its A fragments hold 64
    // registers there) and in flight during the exchange
    const float* rowv = (w == 0 ? lse : dvec) + ((long long)b * H + h) * S;
    float rv[16];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qq = q0 + 8 * i + 2 * t + j;
        rv[2 * i + j] = qq < S ? rowv[qq] * (w == 0 ? kLog2e : 1.f) : 0.f;
      }
    exchange(x, xt, xb, w, rank ^ 1u, tile, tile == n_tiles - 1);
    if (CAP && w == 0) {
      const bool full = tile_full(q0, k0, S, causal, window);
      softcap_p(
          x, pbuf, bars, tile, scale, softcap,
          [&](int i) {
            return full || visible(q0 + 8 * (i / 4) + 2 * t + (i & 1), i % 4 < 2 ? kr0 : kr1, S,
                                   causal, window);
          },
          [&](int i) { return rv[2 * (i / 4) + (i & 1)]; });
    } else if (w == 0) {
      const bool full = tile_full(q0, k0, S, causal, window);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = q0 + 8 * i + 2 * t + (e & 1), kpos = e < 2 ? kr0 : kr1;
          const bool ok = full || visible(qpos, kpos, S, causal, window);
          x[4 * i + e] = ok ? ex2(x[4 * i + e] * scale_l2e - rv[2 * i + (e & 1)]) : 0.f;
        }
      put_p(pbuf, bars, x, tile);
    } else {
      mbar_wait(&bars->pfull, tile & 1);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        x[i] = pbuf[128 * i + threadIdx.x % 128] * (x[i] - rv[2 * (i / 4) + (i & 1)]);
      mbar_arrive(&bars->pempty);
    }
    to_frags(x, fh, fl);
    frag_product<128, Tl::NS>(acc, fh, fl, ring, bars, w, first + (2 + w) * C, phase);
  }

  const long long rstride = (long long)Hkv * D, base = (long long)b * S * rstride + hk * D + col0;
  const float mul = w == 0 ? 1.f : scale;
  if (g == 1) {
    store_acc<128>(acc, w == 0 ? dv : dk, bf16, base, rstride, kr0, S, Dr, mul);
  } else {
    const long long n_el = (long long)B * S * rstride;
    store_acc<128>(acc, parts + ((w == 0 ? g : 0) + part) * n_el, 0, base, rstride, kr0, S, Dr,
                   mul);
  }
}

// dQ of one 64-query tile of one (batch row, q head), on the head_dim
// columns 128 rank.. of cluster CTA `rank`; as flash_bwd_dq_wgmma_kernel,
// S and dP exchanged with the peer, except that both consumers form dQ:
// consumer 1 writes dS over P in the hand-over tile and hands it back, and
// each accumulates dQ += dS K on 64 of the CTA's 128 columns (K transposed,
// chunks 0-1 to consumer 0, 2-3 to consumer 1).  There consumer 1 did both
// dP's product and dQ's, twice consumer 0's work, and held 64 x 128 sums.
template <bool CAP>
__global__ void __launch_bounds__(BwdTileX::THREADS, 1)
flash_bwd_dq_cluster_kernel(const void* __restrict__ q, const void* __restrict__ k,
                            const void* __restrict__ v, const void* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ dvec,
                            void* __restrict__ dq, int B, int S, int H, int Hkv, int D,
                            Strides qs, Strides ks, Strides vs, Strides dos, float scale,
                            int causal, int window, float softcap, int bf16) {
  using Tl = BwdTileX;
  constexpr int C = Tl::C;
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(bwd_smem);
  XBars* xb;
  Bars* bars = init_bars_cluster(smem, &xb);
  const uint32_t rank = cluster_rank();
  const int col0 = 128 * (int)rank, Dr = min(128, D - col0);
  // cluster -> (query tile, head, batch row), heads fastest; causal: the
  // longest query tiles (the most key tiles) first
  const int nqt = (S + kTile - 1) / kTile, cl = blockIdx.x / 2;
  const int hb = cl % (H * B), qt_rev = cl / (H * B);
  const int h = hb % H, b = hb / H, hk = h / (H / Hkv);
  const int q0 = (causal ? nqt - 1 - qt_rev : qt_rev) * kTile;
  const int kv_hi = causal ? min(S, q0 + kTile) : S;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int nt = (kv_hi - kv_lo + kTile - 1) / kTile, n_ring = nt * 3 * C;

  if (threadIdx.x < 256) {   // the stagers
    setmaxnreg_dec<Tl::STAGE_REGS>();
    auto run = [&](auto zero) {
      using E = decltype(zero);
      const E* qp = static_cast<const E*>(q) + b * qs.b + h * qs.h + col0;
      const E* dp = static_cast<const E*>(dout) + b * dos.b + h * dos.h + col0;
      const E* kp = static_cast<const E*>(k) + b * ks.b + hk * ks.h + col0;
      const E* vp = static_cast<const E*>(v) + b * vs.b + hk * vs.h + col0;
      auto item = [&](int i) {
        if (i < 2 * C) {
          const int ch = i % C;
          return i < C ? Chunk<E>{qp + kCh * ch, qs.s, q0, Dr - kCh * ch, false, 0, -1}
                       : Chunk<E>{dp + kCh * ch, dos.s, q0, Dr - kCh * ch, false, 1, -1};
        }
        // K rows (to 0), V rows (1), K transposed (chunks 0-1 to 0, 2-3 to 1)
        const int r = i - 2 * C, j = r / (3 * C), kind = (r / C) % 3, ch = r % C;
        const int k0 = kv_lo + j * kTile;
        return kind == 1   ? Chunk<E>{vp + kCh * ch, vs.s, k0, Dr - kCh * ch, false, 1, kCh * ch}
               : kind == 0 ? Chunk<E>{kp + kCh * ch, ks.s, k0, Dr - kCh * ch, false, 0, -1}
                           : Chunk<E>{kp + kCh * ch, ks.s, k0, Dr - kCh * ch, true, ch / 2, -1};
      };
      stage<Tl, E>(smem, bars, threadIdx.x / 128, 2 * C + n_ring, item, vp, S, Dr);
    };
    if (bf16) run(uint16_t{});
    else run(0.f);
    return;
  }

  setmaxnreg_inc<Tl::MUL_REGS>();
  const int w = threadIdx.x / 128 - 2;   // consumer warpgroup
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, t = lane % 4;
  const int qr0 = q0 + 16 * warp + lane / 4, qr1 = qr0 + 8;   // this thread's queries
  const float* res = reinterpret_cast<const float*>(smem) + w * Tl::RES_OP_WORDS;  // Q or dO
  float* pbuf = reinterpret_cast<float*>(smem + Tl::RES_WORDS);
  float* xt = reinterpret_cast<float*>(smem + Tl::X_OFF) + w * kTile * kTile;
  const uint32_t* ring = smem + Tl::RING_WORDS;
  const float scale_l2e = scale * kLog2e;
  const float* rowv = (w == 0 ? lse : dvec) + ((long long)b * H + h) * S;
  const float mul = w == 0 ? kLog2e : 1.f;
  const float rv0 = qr0 < S ? rowv[qr0] * mul : 0.f, rv1 = qr1 < S ? rowv[qr1] * mul : 0.f;
  float acc[32];       // dQ / scale on columns 64 w.. of this CTA's
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float x[32];         // S, P, then dS (w = 0); dP then dS (w = 1)
  uint32_t fh[8][4], fl[8][4];
  uint32_t phase = 0;
  // dS handed back in the hand-over tile (consumer 1 -> 0).  Consumer 0
  // writes the next tile's P only after reading this tile's dS, which
  // consumer 1 wrote after reading its P: so its put_p / softcap_p are
  // called with n = 0, which skips their own wait for the tile's reader.
  uint64_t* dsfull = &bars->pempty;

  mbar_wait(&bars->res, 0);
  for (int j = 0; j < nt; ++j) {
    const int k0 = kv_lo + j * kTile, first = j * 3 * C;
    ring_product_rs<4>(x, res, ring, bars, w, first + w * C, phase, fh, fl);
    exchange(x, xt, xb, w, rank ^ 1u, j, j == nt - 1);
    if (w == 0) {
      const bool full = tile_full(q0, k0, S, causal, window);
      if constexpr (CAP) {
        softcap_p(
            x, pbuf, bars, 0, scale, softcap,
            [&](int i) {
              return full || visible(i % 4 < 2 ? qr0 : qr1, k0 + 8 * (i / 4) + 2 * t + (i & 1),
                                     S, causal, window);
            },
            [&](int i) { return i % 4 < 2 ? rv0 : rv1; });
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * i + 2 * t + (e & 1), qpos = e < 2 ? qr0 : qr1;
            const bool ok = full || visible(qpos, kpos, S, causal, window);
            x[4 * i + e] = ok ? ex2(x[4 * i + e] * scale_l2e - (e < 2 ? rv0 : rv1)) : 0.f;
          }
        put_p(pbuf, bars, x, 0);
      }
      mbar_wait(dsfull, j & 1);
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] = pbuf[128 * i + threadIdx.x % 128];
    } else {
      mbar_wait(&bars->pfull, j & 1);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float* at = pbuf + 128 * i + threadIdx.x % 128;
        x[i] = *at * (x[i] - (i % 4 < 2 ? rv0 : rv1));
        *at = x[i];
      }
      mbar_arrive(dsfull);
    }
    to_frags(x, fh, fl);
    frag_product<64, Tl::NS>(acc, fh, fl, ring, bars, w, first + 2 * C + 2 * w, phase);
  }

  const long long rstride = (long long)H * D,
                  base = (long long)b * S * rstride + h * D + col0 + 64 * w;
  store_acc<64>(acc, dq, bf16, base, rstride, qr0, S, Dr - 64 * w, scale);
}

// dk, dv (B, S, Hkv, D, contiguous) = the sums of the g parts' fp32
// partials of the dK/dV pass, in the order p = 0, 1, .., g - 1: no atomics,
// the same bits every run.  n = B S Hkv D, a multiple of 8.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_sum_parts_kernel(const float* __restrict__ parts, T* __restrict__ dk,
                           T* __restrict__ dv, long long n, int g) {
  const long long n4 = n / 4;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < 2 * n4;
       i += (long long)gridDim.x * kThreads) {
    const int which = i >= n4;   // 0: dk, 1: dv
    const long long e = i - which * n4;
    const float4* p = reinterpret_cast<const float4*>(parts) + (long long)which * g * n4 + e;
    float4 s = p[0];
    for (int j = 1; j < g; ++j) {
      const float4 y = p[j * n4];
      s.x += y.x;
      s.y += y.y;
      s.z += y.z;
      s.w += y.w;
    }
    T* out = (which ? dv : dk) + 4 * e;
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(out) = s;
    } else {
      __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(out);
      o2[0] = __floats2bfloat162_rn(s.x, s.y);
      o2[1] = __floats2bfloat162_rn(s.z, s.w);
    }
  }
}

template <bool CAP>
int launch_cluster(int dtype, const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* dvec, void* dq, void* dk, void* dv,
                   float* parts, int g, int B, int S, int H, int Hkv, int D, Strides qs,
                   Strides ks, Strides vs, Strides dos, float scale, int causal, int window,
                   float softcap, cudaStream_t st) {
  using Tl = BwdTileX;
  auto kv_kernel = flash_bwd_dkdv_cluster_kernel<CAP>;
  auto q_kernel = flash_bwd_dq_cluster_kernel<CAP>;
  cudaError_t err;
  const void* kernels[2] = {reinterpret_cast<const void*>(kv_kernel),
                            reinterpret_cast<const void*>(q_kernel)};
  for (const void* kern : kernels) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::SMEM);
    if (err != cudaSuccess) return (int)err;
    // the warpgroups' setmaxnreg counts assume this launch count: refuse
    // rather than launch a block that would wait forever
    cudaFuncAttributes attr;
    if ((err = cudaFuncGetAttributes(&attr, kern)) != cudaSuccess) return (int)err;
    if (attr.numRegs != Tl::LAUNCH_REGS) return (int)cudaErrorLaunchOutOfResources;
  }
  const int nt = (S + kTile - 1) / kTile, bf = dtype == 1;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(Tl::THREADS, 1, 1);
  cfg.dynamicSmemBytes = Tl::SMEM;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(2 * nt * Hkv * B * g, 1, 1);
  err = cudaLaunchKernelEx(&cfg, kv_kernel, q, k, v, dout, lse, dvec, dk, dv, parts, g, B, S, H,
                           Hkv, D, qs, ks, vs, dos, scale, causal, window, softcap, bf);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  cfg.gridDim = dim3(2 * nt * H * B, 1, 1);
  err = cudaLaunchKernelEx(&cfg, q_kernel, q, k, v, dout, lse, dvec, dq, B, S, H, Hkv, D, qs, ks,
                           vs, dos, scale, causal, window, softcap, bf);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (g > 1) {
    const long long n = (long long)B * S * Hkv * D, n4 = n / 4;
    const long long want = (2 * n4 + kThreads - 1) / kThreads;
    const unsigned grid = (unsigned)(want < 4096 ? want : 4096);
    if (bf)
      flash_bwd_sum_parts_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
          parts, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), n, g);
    else
      flash_bwd_sum_parts_kernel<float><<<grid, kThreads, 0, st>>>(
          parts, static_cast<float*>(dk), static_cast<float*>(dv), n, g);
  }
  return (int)cudaGetLastError();
}

template <typename T, int NDK, int R>
int launch_simt(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* dvec, void* dq, void* dk, void* dv, int B, int S, int H, int Hkv,
                int D, Strides qs, Strides ks, Strides vs, Strides dos, float scale, int causal,
                int window, float softcap, cudaStream_t st) {
  constexpr int BT = 16 * R;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const size_t smem_kv = sizeof(float) * (size_t)simt_words(BT, D, 2);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_simt_kernel<T, NDK, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_simt_kernel<T, NDK, R><<<dim3((S + BT - 1) / BT, Hkv, B), kThreads, smem_kv, st>>>(
      qt, kt, vt, dot, lse, dvec, static_cast<T*>(dk), static_cast<T*>(dv), S, H, Hkv, D,
      qs, ks, vs, dos, scale, causal, window, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_q = sizeof(float) * (size_t)simt_words(BT, D, 1);
  err = cudaFuncSetAttribute(flash_bwd_dq_simt_kernel<T, NDK, R>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_simt_kernel<T, NDK, R><<<dim3((S + BT - 1) / BT, H, B), kThreads, smem_q, st>>>(
      qt, kt, vt, dot, lse, dvec, static_cast<T*>(dq), S, H, Hkv, D, qs, ks, vs, dos,
      scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

// the SIMT instance for head_dim D: 64-row tiles to 128, 32-row tiles to 256
template <typename T>
int dispatch_simt(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* dvec, void* dq, void* dk, void* dv, int B,
                  int S, int H, int Hkv, int D, Strides qs, Strides ks, Strides vs, Strides dos,
                  float scale, int causal, int window, float softcap, cudaStream_t st) {
  auto go = [&](auto launch) {
    return launch(q, k, v, dout, lse, dvec, dq, dk, dv, B, S, H, Hkv, D, qs, ks, vs, dos, scale,
                  causal, window, softcap, st);
  };
  if (D <= 64) return go(launch_simt<T, 4, 4>);
  if (D <= 96) return go(launch_simt<T, 6, 4>);
  if (D <= 128) return go(launch_simt<T, 8, 4>);
  if (D <= 256) return go(launch_simt<T, 16, 2>);
  return (int)cudaErrorInvalidValue;
}

// Dvec = rowsum(dO * O) into the (B, H, S) scratch, for any route (rowsum(dO
// * (O - mu)) on the tensor-core routes)
template <typename T>
int launch_row_dot(int route, const void* out, const void* dout, const void* v, float* dvec,
                   int B, int S, int H, int Hkv, int D, Strides dos, Strides vs,
                   cudaStream_t st) {
  const Strides os{(long long)S * H * D, (long long)H * D, D};   // out is contiguous
  const long long rows = (long long)B * H * S;
  const unsigned grid = (unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32));
  auto kernel = route == 2   ? flash_bwd_row_dot_kernel<T, 2>
                : route == 1 ? flash_bwd_row_dot_kernel<T, 1>
                             : flash_bwd_row_dot_kernel<T, 0>;
  kernel<<<grid, kThreads, 0, st>>>(static_cast<const T*>(out), static_cast<const T*>(dout),
                                    static_cast<const T*>(v), dvec, B, S, H, H / Hkv, D, os, dos,
                                    vs);
  return (int)cudaGetLastError();
}

// The route of a call: 0 the SIMT kernels, 1 the tensor cores at D <= 128,
// 2 the two-CTA clusters at 128 < D <= 256.  The tensor cores take head_dim
// a multiple of 8 and rows they can copy 4 elements at a time (16-byte fp32
// or 8-byte bf16 runs: 4-element aligned bases and strides).
int bwd_route(int dtype, const void* q, const void* k, const void* v, const void* dout, int D,
              const Strides& qs, const Strides& ks, const Strides& vs, const Strides& dos) {
  auto al = [&](const void* p, const Strides& s) {
    return reinterpret_cast<uintptr_t>(p) % (dtype == 1 ? 8 : 16) == 0 && s.b % 4 == 0 &&
           s.s % 4 == 0 && s.h % 4 == 0;
  };
  if (D % 8 || D > 256 || !(al(q, qs) && al(k, ks) && al(v, vs) && al(dout, dos))) return 0;
  return D <= 128 ? 1 : 2;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q/dout: (B, S, H, D), k/v: (B, S, Hkv, D),
// unit stride on D, (B, S, H) strides in elements in qs/ks/vs/dos.  out: the
// forward's (B, S, H, D) output, contiguous; lse: its (B, H, S) float32
// logsumexp; dvec: (B, H, S) float32 scratch.  dq: (B, S, H, D) and dk/dv:
// (B, S, Hkv, D) contiguous outputs.  window <= 0: no window; softcap <= 0:
// none (as the forward was called).  D <= 256.  parts, g: the dK/dV pass's
// split of each GQA group's q heads on the route at 128 < D <= 256 (g
// divides H / Hkv; where g > 1, parts is (2, g, B, S, Hkv, D) float32
// scratch); the other routes ignore them.
int flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const void* lse,
                        void* dvec, void* dq, void* dk, void* dv, void* parts, int g,
                        int B, int S, int H, int Hkv, int D, const long long* qs,
                        const long long* ks, const long long* vs,
                        const long long* dos, float scale, int causal,
                        int window, float softcap, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv || D <= 0 || D > 256 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides q3{qs[0], qs[1], qs[2]}, k3{ks[0], ks[1], ks[2]}, v3{vs[0], vs[1], vs[2]},
      d3{dos[0], dos[1], dos[2]};
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(dvec);
  const int route = bwd_route(dtype, q, k, v, dout, D, q3, k3, v3, d3);
  if (route == 2 && (g < 1 || (H / Hkv) % g || (g > 1 && parts == nullptr)))
    return (int)cudaErrorInvalidValue;
  int err = dtype == 0
                ? launch_row_dot<float>(route, out, dout, v, df, B, S, H, Hkv, D, d3, v3, st)
                : launch_row_dot<__nv_bfloat16>(route, out, dout, v, df, B, S, H, Hkv, D, d3,
                                                v3, st);
  if (err != 0) return err;
  if (route == 2) {
    auto go = [&](auto launch) {
      return launch(dtype, q, k, v, dout, lf, df, dq, dk, dv, static_cast<float*>(parts), g, B,
                    S, H, Hkv, D, q3, k3, v3, d3, scale, causal, window, softcap, st);
    };
    return softcap > 0.f ? go(launch_cluster<true>) : go(launch_cluster<false>);
  }
  if (route == 1) {
    // the tensor-core route, one instance per head_dim padded to DP, with
    // and without a softcap
    auto go = [&](auto launch_dp) {
      return launch_dp(dtype, q, k, v, dout, lf, df, dq, dk, dv, B, S, H, Hkv, D, q3, k3, v3, d3,
                       scale, causal, window, softcap, st);
    };
    const bool cap = softcap > 0.f;
    if (D <= 32) return cap ? go(launch_wgmma<32, true>) : go(launch_wgmma<32, false>);
    if (D <= 64) return cap ? go(launch_wgmma<64, true>) : go(launch_wgmma<64, false>);
    if (D <= 96) return cap ? go(launch_wgmma<96, true>) : go(launch_wgmma<96, false>);
    return cap ? go(launch_wgmma<128, true>) : go(launch_wgmma<128, false>);
  }
  if (dtype == 0)
    return dispatch_simt<float>(q, k, v, dout, lf, df, dq, dk, dv, B, S, H, Hkv, D, q3, k3, v3,
                                d3, scale, causal, window, softcap, st);
  return dispatch_simt<__nv_bfloat16>(q, k, v, dout, lf, df, dq, dk, dv, B, S, H, Hkv, D, q3, k3,
                                      v3, d3, scale, causal, window, softcap, st);
}

// The route flash_attention_bwd takes for these operands (bwd_route): 0
// SIMT, 1 tensor cores (D <= 128), 2 two-CTA clusters (128 < D <= 256)
int flash_attention_bwd_route(int dtype, const void* q, const void* k, const void* v,
                              const void* dout, int D, const long long* qs, const long long* ks,
                              const long long* vs, const long long* dos) {
  return bwd_route(dtype, q, k, v, dout, D, Strides{qs[0], qs[1], qs[2]},
                   Strides{ks[0], ks[1], ks[2]}, Strides{vs[0], vs[1], vs[2]},
                   Strides{dos[0], dos[1], dos[2]});
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
