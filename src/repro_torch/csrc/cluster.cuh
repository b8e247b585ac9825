// mbarriers and the two-CTA cluster exchange of the head_dim-256 attention
// kernels: flash_attention.cu (the forward) and flash_attention_bwd.cu
// include this file.  A cluster of two CTAs splits head_dim; a product that
// contracts over head_dim is formed by each CTA over its columns as a
// partial 64 x 64 tile, pushed into the peer's shared memory (distributed
// shared memory, st.shared::cluster, then a release arrive on the peer's
// mbarrier) and added in fp32 (exchange, below).
//
// The build hashes every csrc/*.cuh with each .cu (kernels/_build.py), so
// an edit here rebuilds both libraries.
#pragma once
#include "tc_tf32.cuh"

namespace {

// ---- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// arrive with release semantics: this thread's earlier shared-memory
// writes are visible to the threads that see the phase complete
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
               ::"r"(smem_addr(bar)) : "memory");
}
// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// ---- the cluster ------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// the shared::cluster address of `p`'s counterpart in CTA `rank`
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_addr(p)), "r"(rank));
  return out;
}
__device__ __forceinline__ void st_peer4(uint32_t addr, float a, float b, float c, float d) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(a),
               "f"(b), "f"(c), "f"(d) : "memory");
}
// arrive on a peer's mbarrier, releasing this thread's earlier memory
// operations (its pushes) to the cluster
__device__ __forceinline__ void mbar_arrive_peer(uint32_t addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(addr)
               : "memory");
}
// wait for a phase of a local mbarrier that a peer arrives on
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAITX:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAITX;\n}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}
// after one thread's mbar_init calls: they are visible to the cluster, and
// every thread of both CTAs has passed here (so each CTA's barriers are
// ready for its peer's remote arrivals)
__device__ __forceinline__ void cluster_bars_ready() {
  if (threadIdx.x == 0) asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}

// The exchange's barriers, in each CTA: xfull[w] the peer's consumer w has
// pushed its partial into exchange tile w (128 arrivals from the peer);
// xfree[w] the peer has read this CTA's push out of its tile w.
struct XBars {
  uint64_t xfull[2], xfree[2];
};

// Consumer warpgroup w's 64 x 64 product over head_dim, made whole: x holds
// this CTA's partial (its columns); it is pushed into the peer's exchange
// tile w through distributed shared memory (value i of thread j at float4
// 128 (i / 4) + j: the peer's thread j holds the same positions), the
// peer's partial arrives in this CTA's, and x becomes their fp32 sum (IEEE
// addition commutes, so both CTAs hold the same bits: rank 0's half plus
// rank 1's).  Tile n's push waits until the peer has read tile n - 1's; the
// last tile's read is not signalled (nothing waits for it), so no CTA
// touches its peer after the peer's last wait.
__device__ __forceinline__ void exchange(float (&x)[32], float* xt, XBars* xb, int w,
                                         uint32_t peer, int n, bool last) {
  const int j = threadIdx.x % 128;
  if (n > 0) mbar_wait_cluster(&xb->xfree[w], (n - 1) & 1);
  const uint32_t dst = peer_addr(xt, peer);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    st_peer4(dst + 16 * (128 * i + j), x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
  mbar_arrive_peer(peer_addr(&xb->xfull[w], peer));
  mbar_wait_cluster(&xb->xfull[w], n & 1);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 y = reinterpret_cast<const float4*>(xt)[128 * i + j];
    x[4 * i] += y.x;
    x[4 * i + 1] += y.y;
    x[4 * i + 2] += y.z;
    x[4 * i + 3] += y.w;
  }
  if (!last) mbar_arrive_peer(peer_addr(&xb->xfree[w], peer));
}

}  // namespace
