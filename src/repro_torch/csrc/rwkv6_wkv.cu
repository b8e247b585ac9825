// RWKV-6 WKV recurrence from S = 0.
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
//     >= 0.1002 ms at 3.35 TB/s.  This sets the bound;
//   the chunked form's products on the tensor cores: 4 products of 64^3 per
//     (row, 64-step chunk), 4096 pairs x 2.1 MFLOP = 8.6 GFLOP, three TF32
//     passes each: >= 0.052 ms at 495 TFLOP/s;
//   the step-by-step form in fp32 (the d = 32 route, the exact chunks): ~4
//     d^2 operations per (row, step) = 4.3 GFLOP, >= 0.064 ms at 67 TFLOP/s.
//
// Two routes, by head size (a launch that fails raises; nothing gives way
// to another route):
//
// d = 64 (rwkv6-7b): 64-step chunks in matmul form on the tensor cores.
// Step by step, every state entry costs three fp32 instructions a step
// (readout, k v, update): 3.2e9 lane-instructions at the prefill shape, as
// long as the byte bound on the fp32 lanes alone, so no SIMT form comes near
// it.  The TPU kernel's chunked form moves the d^2 work onto the tensor
// cores.  Within a chunk of C = 64 steps, with P(a..b) the product of the
// decays w over steps a..b of key i (1 where a > b):
//   out_t = sum_i r_t P(0..t-1) (S_0 + ...): with m the chunk's middle,
//     rq_t = r_t / P(t..31)  (t < 32)   or  r_t P(32..t-1)  (t >= 32)
//     kq_s = k_s P(s+1..31)  (s < 32)   or  k_s / P(32..s)  (s >= 32)
//   so that rq_t kq_s = r_t k_s P(s+1..t-1), the pair's decay, and
//     A     = (rq kq^T) masked to s < t, bonus_t = sum_i r u k on the diagonal
//     out   = A V + rq (P(0..31) S_0)
//     S_C   = P(0..63) S_0 + P(32..63) kq^T V
//   four products of 64 x 64 x 64 a chunk.  The TPU kernel and repro's
//   model take these factors as exp(+-cumsum(log w)); here they are running
//   products of w from the middle outwards, one multiply and one reciprocal
//   (rcp.approx) a (step, key): a product's relative error grows by ~2^-24
//   a factor whatever its size, where the exponential of a cumulative sum
//   of magnitude L errs by ~L 2^-24 a step (tests/test_torch_wkv_chunked.py:
//   1.4e-6 from float64 against 3.8e-6 at the prefill's draw).
//   * Each operand splits into TF32 parts hi = tf32(x) and lo = tf32(x -
//     hi), and each product sums lo*hi + hi*lo + hi*hi (3xTF32: 24 wgmma
//     m64n128k8 and 48 m64n64k8 a chunk); one pass misses the port's 5e-5
//     by 75x (the test).
//   * Range.  Every factor lies in [P(0..31), 1 / P(0..31)] or [P(32..63),
//     1 / P(32..63)].  A chunk in which either half's product falls below
//     2^-96 for some key (a half-chunk log-decay below -66.5) runs step by
//     step instead, on the state as the registers hold it: the exact
//     branch.  So every factor stays within 2^(+-96) and every operand is
//     finite for |r|, |k| < 2^31; the masked entries s > t of rq kq^T may
//     overflow, and the mask replaces them.  At the model's clamp (log w >=
//     -1 a step: a half-chunk product >= e^-32) no chunk takes the branch;
//     at the unclamped decode-side decays (logits up to 3, log w down to
//     -20 a step) nearly every chunk does.  The result is the recurrence's
//     for every w in [0, 1]: a w of 0 sends its chunk to the exact branch.
//   * A block (384 threads, three warpgroups) owns one row, one block an
//     SM (226 KB of shared memory); 512 / 132 = 3.9 waves of rows at the
//     prefill shape.  Each warpgroup runs its own loop over the chunks (its
//     registers live only there); the loops meet at each chunk's top
//     barrier and at the end of its staging.
//   * Copies: r, k, w and v of a chunk go into a ring of two 64 KB slots
//     (cp.async, 16-byte copies, each 16-byte group of a row placed at
//     group ^ (t % 8), so that the fragment reads hit distinct banks; steps
//     past S are zeros, their w taken as 1), each element crossing device
//     memory once.  Chunk n + 2's tiles go into chunk n's slot one by one
//     as chunk n is done with them, each copied by the warpgroup that last
//     reads it (w and v by warpgroup 2 after the staging, r by 0 after
//     rq's fragments, k by 1 after kq^T's; all four by 1 after an exact
//     chunk).  Copying a whole chunk at once held its warps ~4.7k cycles
//     while every SM's requests queued for the memory.
//   * Warpgroup 2 prepares chunk n + 1 while warpgroups 0 and 1 multiply
//     chunk n: the bonus (two threads a step); the decays' running products
//     (a thread a key and half chunk) and the branch; rq and kq in place of
//     r and k.
//   * All three warpgroups then stage: kq split into the B operand of rq
//     kq^T (K-major, as it lies); v transposed and split into the B operand
//     of A V and kq^T V, its steps permuted within each 8-step group so that
//     the A accumulator's registers are A V's A fragments as they stand (the
//     flash kernels' permutation, csrc/tc_tf32.cuh store_vt).
//   * The products, split by role so that each warpgroup's run overlaps the
//     other's.  Warpgroup 1 holds the state across chunks in the
//     accumulator layout (S[i][j], keys i on the rows): it writes P(0..31)
//     S, split and transposed, beside kq in one B operand of 128 rows, then
//     takes kq^T's fragments and runs kq^T V from zero, added to the decayed
//     state in fp32 (the tensor core truncates its sums, so it never
//     carries the state).  Warpgroup 0 takes rq's fragments and runs [rq
//     kq^T | rq P(0..31) S] as one m64n128 product, masks A and puts the
//     bonus on its diagonal, runs A V from zero (o cannot carry on as an
//     m64n64 accumulator after being half of an m64n128 one: ptxas then
//     serializes every wgmma of the kernel, C7511), adds it in fp32 and
//     stores out (float2).
//   * Earlier designs, slower at the prefill shape (chip_wkv_ablation.py
//     --against, PERF.md): one warpgroup running every product after both
//     staged (0.35 ms); two blocks an SM of one warpgroup each (0.40 ms:
//     the blocks waited for their copies together); two warpgroups that
//     prepared, staged and then multiplied in turn (0.22 ms); bulk copies
//     of each row by the Tensor Memory Accelerator (0.27 ms: 448 copies of
//     at most 256 bytes a chunk landed late).
//   * No atomics: two runs give the same bits.
//
// d = 32 (the smoke configuration): (k ...)^T V would have 32 rows, below
// wgmma's 64, so the SIMT kernel below serves it: serial in time, no
// exponential of a cumulative sum, exact for any w in [0, 1].
//   * Value columns are independent: S[:, j] needs only r_t, k_t, w_t and
//     v_t[j].  A block owns one row: d threads, in groups of kLanes = 4
//     lanes that share kCols = 4 columns and split the d keys four ways.  A
//     thread keeps (d / 4) x 4 state entries in registers.
//   * r, k, w and v of kRun steps are copied into shared memory with
//     cp.async, two runs in flight.
//   * The bonus term sum_i r_t[i] u[i] k_t[i] is the same for every column:
//     one warp reduction per step computes it.
//   * The four lanes' partial readouts of their four columns are summed by a
//     transposing butterfly; outputs go through shared memory to coalesced
//     float4 stores.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6, row 6): at the
// prefill shape 0.2075 ms of device time, 48% of the byte bound, against
// the step-by-step kernel's 0.2173-0.2223 in the same turns; ptxas 161
// registers, no spills, the wgmmas pipelined.  What holds it back
// (chip_wkv_ablation.py): no one kind of work; without the products, the
// decay factors, the loads or the stores it keeps 90-97% of its time.  The
// three warpgroups' paths through a chunk are about even, and each is slowed
// by the shared-memory traffic of the others (copies landing, staging,
// fragment reads and the wgmmas' B operands).
#include "tc_tf32.cuh"

namespace {

struct RowStrides {
  long long b, h, s;
};

__device__ __forceinline__ void copy16_async(float* smem, const float* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned n = valid ? 16 : 0;   // 0: fill zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}

// ---------------------------------------------------------------------------
// d = 64: the chunked form on the tensor cores (3xTF32 wgmma)
// ---------------------------------------------------------------------------

constexpr int kC = 64;              // steps a chunk = d
constexpr int kTcThreads = 384;     // three warpgroups
// a half chunk's decay product below this sends the chunk to the exact
// branch (2^-96: log-decay -66.5 over 32 steps)
constexpr float kMinHalfDecay = 0x1p-96f;

// Shared memory, in 4-byte words: the ring (two slots of r, k, w, v, 64 x
// 64 fp32 each, 16-byte groups swizzled; r becomes rq and k kq in place);
// the B operand of [rq kq^T | rq P(0..31) S], 128 rows (kq's 64 steps, then
// S's 64 columns) in hi and lo parts (the exact branch keeps its sums in
// S's rows); v transposed, the B operand of A V and kq^T V, hi and lo; then
// for each parity of the chunk index the bonus, P(0..31) and P(32..63) of
// each key and the branch taken; u.
constexpr int kTile = kC * kC;
constexpr int kSlot = 4 * kTile;
constexpr int kBh = 2 * kSlot, kBl = kBh + 2 * kTile, kVt = kBl + 2 * kTile;
constexpr int kBonus = kVt + 2 * kTile, kB0 = kBonus + 2 * kC, kF63 = kB0 + 2 * kC;
constexpr int kU = kF63 + 2 * kC, kFlag = kU + kC;
constexpr int kTcSmem = (kFlag + 4) * 4;
static_assert(kTcSmem <= 232448, "shared memory of one block");
// named barriers (0 is __syncthreads): S staged for rq S (warpgroup 1
// arrives, 0 waits); warpgroup 1 alone; warpgroup 2 alone
constexpr int kBarSt = 1, kBarWg1 = 2, kBarWg2 = 4;

// word of (step t, column c) in a ring tile: 16-byte group c / 4 of row t
// at group (c / 4) ^ (t % 8)
__device__ __forceinline__ int sw(int t, int c) {
  return t * kC + ((((c >> 2) ^ (t & 7)) << 2) | (c & 3));
}
// word of (n, c) in a K-major wgmma operand without swizzle, 64 columns
// (8 x 4 core matrices, 128 bytes apart along c and 2048 along n)
__device__ __forceinline__ int kmaj(int n, int c) {
  return ((n >> 3) * 16 + (c >> 2)) * 32 + (n & 7) * 4 + (c & 3);
}
// 1 / x on the special-function unit (relative error ~2^-23)
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// whether any of the `count` threads at barrier `id` passes a non-zero
// `pred` (a barrier too)
__device__ __forceinline__ bool bar_or(int id, int count, int pred) {
  unsigned res;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 q, %1, 0;\nbar.red.or.pred p, %2, %3, q;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(res) : "r"(pred), "r"(id), "r"(count) : "memory");
  return res != 0;
}
// an int the compiler cannot see through: the offsets derived from it in
// the chunk loop are recomputed where they are used, not held in registers
// across the loop
__device__ __forceinline__ int opaque_int(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// [d0 | d1] (64 x 128: d0 columns 0..63, d1 64..127) (+)= A B^T, TF32, A
// from registers as in wgmma_rs_n64
__device__ __forceinline__ void wgmma_rs_n128(float (&d0)[32], float (&d1)[32],
                                              const uint32_t (&a)[4], uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]), "+f"(d0[4]), "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]),
        "+f"(d0[8]), "+f"(d0[9]), "+f"(d0[10]), "+f"(d0[11]), "+f"(d0[12]), "+f"(d0[13]), "+f"(d0[14]), "+f"(d0[15]),
        "+f"(d0[16]), "+f"(d0[17]), "+f"(d0[18]), "+f"(d0[19]), "+f"(d0[20]), "+f"(d0[21]), "+f"(d0[22]), "+f"(d0[23]),
        "+f"(d0[24]), "+f"(d0[25]), "+f"(d0[26]), "+f"(d0[27]), "+f"(d0[28]), "+f"(d0[29]), "+f"(d0[30]), "+f"(d0[31]),
        "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]), "+f"(d1[3]), "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]),
        "+f"(d1[8]), "+f"(d1[9]), "+f"(d1[10]), "+f"(d1[11]), "+f"(d1[12]), "+f"(d1[13]), "+f"(d1[14]), "+f"(d1[15]),
        "+f"(d1[16]), "+f"(d1[17]), "+f"(d1[18]), "+f"(d1[19]), "+f"(d1[20]), "+f"(d1[21]), "+f"(d1[22]), "+f"(d1[23]),
        "+f"(d1[24]), "+f"(d1[25]), "+f"(d1[26]), "+f"(d1[27]), "+f"(d1[28]), "+f"(d1[29]), "+f"(d1[30]), "+f"(d1[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64) = A B^T from zero in three TF32 passes, A's parts in
// registers as the fragments of the 8 k-steps, B's parts at descriptors bh,
// bl.  Issued only; the caller commits and waits.
__device__ __forceinline__ void mma3(float (&d)[32], const uint32_t (&ah)[8][4],
                                     const uint32_t (&al)[8][4], uint64_t bh, uint64_t bl) {
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    wgmma_rs_n64(d, al[u], bh + 16 * u, u > 0);
    wgmma_rs_n64(d, ah[u], bl + 16 * u, 1);
    wgmma_rs_n64(d, ah[u], bh + 16 * u, 1);
  }
}
// the same over 128 columns [d0 | d1], from zero
__device__ __forceinline__ void mma3_n128(float (&d0)[32], float (&d1)[32],
                                          const uint32_t (&ah)[8][4],
                                          const uint32_t (&al)[8][4], uint64_t bh, uint64_t bl) {
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    wgmma_rs_n128(d0, d1, al[u], bh + 16 * u, u > 0);
    wgmma_rs_n128(d0, d1, ah[u], bl + 16 * u, 1);
    wgmma_rs_n128(d0, d1, ah[u], bh + 16 * u, 1);
  }
}

__device__ __forceinline__ void fence_all(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) fence_reg(d[i]);
}
__device__ __forceinline__ void fence_all(uint32_t (&a)[8][4]) {
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) fence_reg(a[u][e]);
}

// What the three warpgroups share: the shared memory, the row's inputs and
// output, and the staging of a prepared chunk into the B operands.
struct TcRow {
  float* sm;
  const float* src[4];    // r, k, w, v of the row (b, h)
  long long step[4];      // their step strides
  float* out;             // the row's (S, 64) output
  int S, n_chunks;

  __device__ __forceinline__ float* slot(int c) const { return sm + (c & 1) * kSlot; }
  __device__ __forceinline__ uint32_t* words(int at) const {
    return reinterpret_cast<uint32_t*>(sm) + at;
  }
  __device__ __forceinline__ bool exact(int c) const {
    return reinterpret_cast<const int*>(sm)[kFlag + (c & 1)] != 0;
  }

  // All three warpgroups, for prepared chunk c: kq as it lies into rows
  // 0..63 of the B operand of [rq kq^T | rq S] (n = step, k = key), and v
  // transposed into the B operand of A V and kq^T V (n = column, k = step
  // slot; slot 8 q + e holds step 8 q + 2 e for e < 4, 8 q + 2 (e - 4) + 1
  // for e >= 4), hi and lo parts; a warp takes 32 units of one row group or
  // one slot group.  Loads first, then the stores (a store between two loads
  // would hold the second back: the compiler cannot tell that they do not
  // alias).  Ends with the barrier after which the products may start.
  __device__ __forceinline__ void stage_operands(int c) const {
    const int tid = opaque_int(threadIdx.x), lane = tid % 32;
    const float* K = slot(c) + kTile;
    const float* V = slot(c) + 3 * kTile;
    float4 xk[3];
    float xv[3][4];
#pragma unroll
    for (int it = 0; it < 3; ++it) {
      const int combo = (it * kTcThreads + tid) / 32;
      if (combo >= 32) break;
      const int sr = (combo % 8) * 8 + lane % 8, col = (combo / 8) * 16 + 4 * (lane / 8);
      xk[it] = *reinterpret_cast<const float4*>(K + sw(sr, col));
      const int q = combo % 16, j = (combo / 16) * 32 + lane;
      const int s0 = 8 * (q / 2) + q % 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) xv[it][e] = V[sw(s0 + 2 * e, j)];
    }
#pragma unroll
    for (int it = 0; it < 3; ++it) {
      const int combo = (it * kTcThreads + tid) / 32;
      if (combo >= 32) break;
      const int sr = (combo % 8) * 8 + lane % 8, col = (combo / 8) * 16 + 4 * (lane / 8);
      uint32_t hh[4], ll[4];
      split(xk[it].x, hh[0], ll[0]);
      split(xk[it].y, hh[1], ll[1]);
      split(xk[it].z, hh[2], ll[2]);
      split(xk[it].w, hh[3], ll[3]);
      *reinterpret_cast<uint4*>(words(kBh) + kmaj(sr, col)) = make_uint4(hh[0], hh[1], hh[2], hh[3]);
      *reinterpret_cast<uint4*>(words(kBl) + kmaj(sr, col)) = make_uint4(ll[0], ll[1], ll[2], ll[3]);
      const int q = combo % 16, j = (combo / 16) * 32 + lane;
#pragma unroll
      for (int e = 0; e < 4; ++e) split(xv[it][e], hh[e], ll[e]);
      *reinterpret_cast<uint4*>(words(kVt) + kmaj(j, 4 * q)) = make_uint4(hh[0], hh[1], hh[2], hh[3]);
      *reinterpret_cast<uint4*>(words(kVt + kTile) + kmaj(j, 4 * q)) =
          make_uint4(ll[0], ll[1], ll[2], ll[3]);
    }
    fence_proxy_async();
    __syncthreads();
  }
};

// ---- warpgroup 2: the copies and each chunk's preparation, one chunk
// ahead of the products

// tile x (0 r, 1 k, 2 w, 3 v) of chunk c into ring slot c % 2 by one
// warpgroup (wt: its thread 0..127): 64 rows x 16 groups of 16 bytes, 8 a
// thread, neighbouring threads on one row; rows past S zeros.  Committed
// as one group; every thread waits for its groups before the chunk's top
// barrier.
__device__ __forceinline__ void copy_tile(const TcRow& row, int c, int x, int wt) {
  const int t0 = c * kC;
#pragma unroll
  for (int it = 0; it < kC * 16 / 128; ++it) {
    const int f = it * 128 + wt, t = f / 16, col = 4 * (f % 16);
    const bool valid = t0 + t < row.S;
    copy16_async(row.slot(c) + x * kTile + sw(t, col),
                 row.src[x] + (valid ? t0 + t : 0) * row.step[x] + col, valid);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Warpgroup 2's decay chains over one half of chunk c for key ki: HF 0
// walks steps 31..0 (P(t..31)), HF 1 steps 32..63 (P(32..t)).  The steps
// are compile-time constants in each half, so the swizzled offsets cost one
// operation each.
template <int HF>
__device__ __forceinline__ int chain_at(int s, int ki) {
  return sw(HF ? 32 + s : 31 - s, ki);
}
// the half's decays (w taken as 1 past S) into wq and its product into
// P(0..31) or P(32..63); returns whether any key's product falls below
// kMinHalfDecay (or is NaN), the branch of the whole chunk
template <int HF>
__device__ __forceinline__ bool chain_products(const TcRow& row, int c, int ki, float (&wq)[32]) {
  const int par = c & 1, t0 = c * kC;
  const float* W = row.slot(c) + 2 * kTile;
  float prod = 1.f;
#pragma unroll
  for (int s = 0; s < 32; ++s) {
    wq[s] = t0 + (HF ? 32 + s : 31 - s) < row.S ? W[chain_at<HF>(s, ki)] : 1.f;
    prod *= wq[s];
  }
  row.sm[(HF ? kF63 : kB0) + par * kC + ki] = prod;
  return bar_or(kBarWg2, 128, !(prod >= kMinHalfDecay));
}
// rq and kq in place of r and k over the half: all loads first, then the
// running products, then all stores (a store between two loads would hold
// the second back: the compiler cannot tell that they do not alias)
template <int HF>
__device__ __forceinline__ void chain_convert(const TcRow& row, int c, int ki,
                                              const float (&wq)[32]) {
  float* R = row.slot(c);
  float* K = R + kTile;
  float rv[32], kv[32];
#pragma unroll
  for (int s = 0; s < 32; ++s) {
    rv[s] = R[chain_at<HF>(s, ki)];
    kv[s] = K[chain_at<HF>(s, ki)];
  }
  float p = 1.f;
#pragma unroll
  for (int s = 0; s < 32; ++s) {
    if (HF) {
      rv[s] *= p;                              // r_t P(32..t-1)
      p *= wq[s];
      kv[s] *= rcp(p);                         // k_t / P(32..t)
    } else {
      kv[s] *= p;                              // k_t P(t+1..31)
      p *= wq[s];
      rv[s] *= rcp(p);                         // r_t / P(t..31)
    }
  }
#pragma unroll
  for (int s = 0; s < 32; ++s) {
    R[chain_at<HF>(s, ki)] = rv[s];
    K[chain_at<HF>(s, ki)] = kv[s];
  }
}

// chunk c, landed in its slot: the bonus sum_i r u k of each step (two
// threads a step, 32 keys each), then the decays' products and the branch
// (a thread a key and half chunk); returns the branch
__device__ __forceinline__ bool prepare_products(const TcRow& row, int c, float (&wq)[32]) {
  const int tid = opaque_int(threadIdx.x) - 256, par = c & 1;
  float* sm = row.sm;
  const float* R = row.slot(c);
  const float* K = R + kTile;
  {
    const int t = tid / 2, c0 = 32 * (tid % 2);
    float acc = 0.f;
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int col = c0 + 4 * x;
      const float4 r4 = *reinterpret_cast<const float4*>(R + sw(t, col));
      const float4 k4 = *reinterpret_cast<const float4*>(K + sw(t, col));
      const float4 u4 = *reinterpret_cast<const float4*>(sm + kU + col);
      acc = fmaf(r4.x * u4.x, k4.x, acc);
      acc = fmaf(r4.y * u4.y, k4.y, acc);
      acc = fmaf(r4.z * u4.z, k4.z, acc);
      acc = fmaf(r4.w * u4.w, k4.w, acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (tid % 2 == 0) sm[kBonus + par * kC + t] = acc;
  }
  const bool exact = tid < kC ? chain_products<0>(row, c, tid, wq)
                              : chain_products<1>(row, c, tid - kC, wq);
  if (tid == 0) reinterpret_cast<int*>(sm)[kFlag + par] = exact;
  return exact;
}
__device__ __forceinline__ void prepare_convert(const TcRow& row, int c, const float (&wq)[32]) {
  const int tid = opaque_int(threadIdx.x) - 256;
  if (tid < kC) chain_convert<0>(row, c, tid, wq);
  else chain_convert<1>(row, c, tid - kC, wq);
}

__device__ __forceinline__ void producer(const TcRow& row) {
  float wq[32];
  const int wt = opaque_int(threadIdx.x) - 256;
  for (int c = 0; c < min(2, row.n_chunks); ++c)
    for (int x = 0; x < 4; ++x) copy_tile(row, c, x, wt);
  asm volatile("cp.async.wait_group 0;\n" ::);
  bar_sync(kBarWg2, 128);
  if (!prepare_products(row, 0, wq)) prepare_convert(row, 0, wq);
  for (int n = 0; n < row.n_chunks; ++n) {
    const bool more2 = n + 2 < row.n_chunks;
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();   // chunk n prepared; chunk n - 1's products done; chunk n + 1 landed
    if (!row.exact(n)) {
      row.stage_operands(n);
      // chunk n's w (read by its preparation) and v (by the staging) are
      // done with: chunk n + 2's take their place
      if (more2) {
        copy_tile(row, n + 2, 2, wt);
        copy_tile(row, n + 2, 3, wt);
      }
    }
    // chunk n + 1: the bonus, the decays' products and the branch, then
    // rq and kq
    if (n + 1 < row.n_chunks && !prepare_products(row, n + 1, wq))
      prepare_convert(row, n + 1, wq);
  }
}

// ---- warpgroup 0, the output: [rq kq^T | rq P(0..31) S], the mask and the
// bonus, + A V
__device__ __forceinline__ void output_products(const TcRow& row) {
  for (int n = 0; n < row.n_chunks; ++n) {
    const int t0 = n * kC, steps = min(kC, row.S - t0), par = n & 1;
    const bool more2 = n + 2 < row.n_chunks;
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();   // chunk n prepared; chunk n - 1's products done
    if (row.exact(n)) continue;
    row.stage_operands(n);
    const int tid = opaque_int(threadIdx.x), lane = tid % 32, g = lane / 4, tq = lane % 4;
    const int ra = 16 * (tid / 32) + g, rb = ra + 8;   // steps t
    const float* R = row.slot(n);
    // rq's fragments: a[0] (ra, 8 u + tq), a[1] (rb, ..), a[2] (ra, 8 u + tq
    // + 4), a[3] (rb, ..)
    uint32_t ah[8][4], al[8][4];
#pragma unroll
    for (int uu = 0; uu < 8; ++uu)
#pragma unroll
      for (int a = 0; a < 4; ++a)
        split(R[sw(a & 1 ? rb : ra, 8 * uu + tq + (a & 2) * 2)], ah[uu][a], al[uu][a]);
    if (more2) copy_tile(row, n + 2, 0, tid);   // chunk n's r is done with
    float acc[32], o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      o[i] = 0.f;
      acc[i] = 0.f;
    }
    fence_all(o);
    fence_all(acc);
    fence_all(ah);
    fence_all(al);
    bar_sync(kBarSt, 2 * 128);   // warpgroup 1 has staged P(0..31) S
    wgmma_fence();
    mma3_n128(acc, o, ah, al, wgmma_desc(row.words(kBh), 128, 2048),
              wgmma_desc(row.words(kBl), 128, 2048));
    wgmma_commit();
    wgmma_wait0();
    fence_all(o);
    fence_all(acc);
    fence_all(ah);
    fence_all(al);
    // A: s < t kept, the bonus on the diagonal (out_t += bonus_t v_t); its
    // registers as A V's fragments (the permuted steps)
    uint32_t ph[8][4], pl[8][4];
    {
      const float ba = row.sm[kBonus + par * kC + ra], bb = row.sm[kBonus + par * kC + rb];
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = e < 2 ? ra : rb, s = 8 * q + 2 * tq + (e & 1);
          const int a = e == 1 ? 2 : e == 2 ? 1 : e;
          split(s < t ? acc[4 * q + e] : s == t ? (e < 2 ? ba : bb) : 0.f, ph[q][a], pl[q][a]);
        }
    }
    // A V from zero, added to o in fp32: o cannot carry on as the
    // accumulator of an m64n64 product after being half of an m64n128 one
    // (ptxas then serializes every wgmma of the kernel)
    float av[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) av[i] = 0.f;
    fence_all(av);
    fence_all(ph);
    fence_all(pl);
    wgmma_fence();
    mma3(av, ph, pl, wgmma_desc(row.words(kVt), 128, 2048),
         wgmma_desc(row.words(kVt + kTile), 128, 2048));
    wgmma_commit();
    wgmma_wait0();
    fence_all(av);
    fence_all(ph);
    fence_all(pl);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] += av[i];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = half ? rb : ra;
      if (t >= steps) continue;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
        *reinterpret_cast<float2*>(row.out + (long long)(t0 + t) * kC + 8 * nb + 2 * tq) =
            make_float2(o[4 * nb + 2 * half], o[4 * nb + 2 * half + 1]);
    }
  }
}

// ---- warpgroup 1, the state S[i][j] (keys i on the rows) in the
// accumulator layout across chunks: P(0..31) S, transposed (n = column j, k
// = key i), into rows 64..127 of the B operand; kq^T V from zero; S =
// P(0..63) S + P(32..63) kq^T V in fp32 (the tensor core truncates its sums,
// so it never carries the state).  Chunks with the exact branch run the
// recurrence step by step here.
__device__ __forceinline__ void state_products(const TcRow& row) {
  float st[32];   // st[4 n + e] = S[e < 2 ? ra : rb][8 n + 2 tq + e % 2]
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = 0.f;
  for (int n = 0; n < row.n_chunks; ++n) {
    const int t0 = n * kC, steps = min(kC, row.S - t0), par = n & 1;
    const bool more2 = n + 2 < row.n_chunks;
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();   // chunk n prepared; chunk n - 1's products done
    const bool exact = row.exact(n);
    if (!exact) row.stage_operands(n);
    const int tid = opaque_int(threadIdx.x) - 128, lane = tid % 32, g = lane / 4, tq = lane % 4;
    const int ra = 16 * (tid / 32) + g, rb = ra + 8;   // keys i
    float* sm = row.sm;
    const float* R = row.slot(n);
    const float* K = R + kTile;
    const float* W = K + kTile;
    const float* V = W + kTile;
    if (!exact) {
      uint32_t* Sh = row.words(kBh + kTile);
      uint32_t* Sl = row.words(kBl + kTile);
      const float b0a = sm[kB0 + par * kC + ra], b0b = sm[kB0 + par * kC + rb];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int off = kmaj(8 * nb + 2 * tq + (e & 1), e < 2 ? ra : rb);
          split(st[4 * nb + e] * (e < 2 ? b0a : b0b), Sh[off], Sl[off]);
        }
      fence_proxy_async();
      bar_arrive(kBarSt, 2 * 128);
      // kq^T's fragments over the permuted steps: a[0] (key ra, step 8 q + 2
      // tq), a[1] (rb, ..), a[2] (ra, 8 q + 2 tq + 1), a[3] (rb, ..)
      uint32_t ah[8][4], al[8][4];
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int a = 0; a < 4; ++a)
          split(K[sw(8 * q + 2 * tq + (a >> 1), a & 1 ? rb : ra)], ah[q][a], al[q][a]);
      if (more2) copy_tile(row, n + 2, 1, tid);   // chunk n's k is done with
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      fence_all(acc);
      fence_all(ah);
      fence_all(al);
      wgmma_fence();
      mma3(acc, ah, al, wgmma_desc(row.words(kVt), 128, 2048),
           wgmma_desc(row.words(kVt + kTile), 128, 2048));   // kq^T V
      wgmma_commit();
      wgmma_wait0();
      fence_all(acc);
      fence_all(ah);
      fence_all(al);
      const float fa = sm[kF63 + par * kC + ra], fb = sm[kF63 + par * kC + rb];
      const float da = b0a * fa, db = b0b * fb;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        st[i] = fmaf(st[i], i % 4 < 2 ? da : db, acc[i] * (i % 4 < 2 ? fa : fb));
      continue;
    }
    // the exact branch: each warp's readout (16 keys) summed over the 8
    // lanes of a column group, the 4 warps' sums through shared memory
    float* red = sm + kBh + kTile;   // [2][4][64], in S's rows of the B operand
    for (int s = 0; s < steps; ++s) {
      const float r0 = R[sw(s, ra)], r1 = R[sw(s, rb)];
      const float k0 = K[sw(s, ra)], k1 = K[sw(s, rb)];
      const float w0 = W[sw(s, ra)], w1 = W[sw(s, rb)];
      float p[16];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const float2 v2 = *reinterpret_cast<const float2*>(V + sw(s, 8 * nb + 2 * tq));
        const float vj[2] = {v2.x, v2.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& sa = st[4 * nb + e];
          float& sb = st[4 * nb + 2 + e];
          p[2 * nb + e] = fmaf(r1, sb, r0 * sa);
          sa = fmaf(w0, sa, k0 * vj[e]);
          sb = fmaf(w1, sb, k1 * vj[e]);
        }
      }
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        p[x] += __shfl_xor_sync(0xffffffffu, p[x], 4);
        p[x] += __shfl_xor_sync(0xffffffffu, p[x], 8);
        p[x] += __shfl_xor_sync(0xffffffffu, p[x], 16);
      }
      if (g == 0) {
        float* dst = red + (s & 1) * 4 * kC + (tid / 32) * kC;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
          *reinterpret_cast<float2*>(dst + 8 * nb + 2 * tq) = make_float2(p[2 * nb], p[2 * nb + 1]);
      }
      bar_sync(kBarWg1, 128);
      if (tid < kC) {
        const float* rr = red + (s & 1) * 4 * kC + tid;
        row.out[(long long)(t0 + s) * kC + tid] =
            ((rr[0] + rr[kC]) + (rr[2 * kC] + rr[3 * kC])) + sm[kBonus + par * kC + s] * V[sw(s, tid)];
      }
    }
    // the exact chunk's slot is done with: all of chunk n + 2
    if (more2)
      for (int x = 0; x < 4; ++x) copy_tile(row, n + 2, x, tid);
  }
}

__global__ void __launch_bounds__(kTcThreads, 1)
rwkv6_wkv_tc_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u, float* __restrict__ out, int H, int S,
                    RowStrides rs, RowStrides ks, RowStrides vs, RowStrides ws) {
  extern __shared__ __align__(1024) float sm[];
  const long long b = blockIdx.x / H, h = blockIdx.x % H;
  const TcRow row{sm,
                  {r + b * rs.b + h * rs.h, k + b * ks.b + h * ks.h, w + b * ws.b + h * ws.h,
                   v + b * vs.b + h * vs.h},
                  {rs.s, ks.s, ws.s, vs.s},
                  out + (long long)blockIdx.x * S * kC,
                  S,
                  (S + kC - 1) / kC};
  if (threadIdx.x < kC) sm[kU + threadIdx.x] = u[h * kC + threadIdx.x];
  __syncthreads();
  // one loop a warpgroup, each with its own registers; every loop meets the
  // same block-wide barriers: the chunk's top and, unless it runs exactly,
  // the end of the staging
  if (threadIdx.x >= 256) producer(row);
  else if (threadIdx.x >= 128) state_products(row);
  else output_products(row);
}

// ---------------------------------------------------------------------------
// d = 32: the recurrence step by step on the SIMT lanes
// ---------------------------------------------------------------------------

constexpr int kRun = 16;     // time steps per staged run; two runs in flight
constexpr int kLanes = 4;    // lanes that split the keys of a column group
constexpr int kCols = 4;     // value columns a thread owns

template <int D>
struct Stage {
  float in[2][4][kRun][D];   // r, k, w, v of two runs
  float out[kRun][D];
  float bonus[kRun];
  float u[D];
};

template <int D>
__global__ void __launch_bounds__(D)
rwkv6_wkv_simt_kernel(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u, float* __restrict__ out, int H, int S,
                      RowStrides rs, RowStrides ks, RowStrides vs, RowStrides ws) {
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
        copy16_async(&sm.in[buf][x][s][c4], src[x] + (t0 + s) * step[x] + c4, true);
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
    const float(*sw_)[D] = sm.in[buf][2];
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
        const float4 w4 = *reinterpret_cast<const float4*>(&sw_[s][16 * m + 4 * q]);
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

RowStrides strides_of(const long long* s) { return RowStrides{s[0], s[1], s[2]}; }

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
  if (d == 64) {
    cudaError_t err = cudaFuncSetAttribute(
        rwkv6_wkv_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
    if (err != cudaSuccess) return (int)err;
    rwkv6_wkv_tc_kernel<<<grid, kTcThreads, kTcSmem, st>>>(
        rf, kf, vf, wf, uf, of, H, S, strides_of(rs), strides_of(ks), strides_of(vs),
        strides_of(ws));
  } else {
    rwkv6_wkv_simt_kernel<32><<<grid, 32, 0, st>>>(rf, kf, vf, wf, uf, of, H, S, strides_of(rs),
                                                  strides_of(ks), strides_of(vs), strides_of(ws));
  }
  return (int)cudaGetLastError();
}

const char* rwkv6_wkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
