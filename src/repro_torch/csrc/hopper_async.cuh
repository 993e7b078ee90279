// Shared-memory barriers, bulk copies and thread-block-cluster helpers for
// sm_90a, used by the dueling Q-network's inference kernel and the agents'
// TD-step kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Spin until the barrier's phase of parity `parity` has completed; a wait
// that never ends (a lost copy) traps after ~2^28 tries instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (tries == (1u << 28)) __trap();
  }
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, counted on `bar`.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- thread-block clusters (every thread of every CTA calls the barrier
// functions, in the same order) ----

// Arrive on the cluster barrier without ordering memory: "this CTA has
// started", before any other CTA may write into its shared memory.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// Arrive, releasing this thread's writes (local and remote) to the cluster.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

// Wait for every thread of the cluster to arrive, acquiring their writes.
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of `local`'s offset in the shared memory of cluster CTA `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_u32(local)), "r"(rank));
  return remote;
}

__device__ __forceinline__ void st_cluster(const float* local, int rank,
                                           float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n"
               :: "r"(cluster_addr(local, rank)), "f"(v) : "memory");
}

__device__ __forceinline__ void st_cluster4(const float* local, int rank,
                                            float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(cluster_addr(local, rank)), "f"(v.x), "f"(v.y),
                  "f"(v.z), "f"(v.w) : "memory");
}
