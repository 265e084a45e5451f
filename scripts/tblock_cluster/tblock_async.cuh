// The asynchronous copies of the temporal-block window (tblock_window.cuh),
// for Hopper:
// * a tile's part, staged into shared memory: one cp.async a float, which
//   the block waits for before the tile's first step, and the next tile's
//   part prefetched into L2 while this one steps;
// * the populations that cross between the blocks of a thread-block
//   cluster: a store into another block's shared memory (st.async through
//   distributed shared memory) that completes a transaction on an mbarrier
//   of that block, which the cells that read them wait on;
// * the cluster barrier, split into its arrival and its wait.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace lbm {
namespace async {

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An mbarrier of one arrival (its thread's expect_tx) and the bytes that
// the cluster's other blocks store into this one; made visible to them by
// the cluster barrier that follows the staging.
__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// This block expects `bytes` more on `bar` in its current phase, and
// arrives.
__device__ __forceinline__ void bar_expect(unsigned long long* bar, const unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of `bar` with this parity has completed: its bytes
// have landed (acquire at cluster scope, so the other blocks' stores show).
__device__ __forceinline__ void bar_wait(unsigned long long* bar, const unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT%=:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT%=;\n"
      "}\n" ::"r"(smem(bar)),
      "r"(parity)
      : "memory");
}

// The cluster barrier in two halves: every thread of every block of the
// cluster arrives (releasing what it did before), and later waits for all
// of them (acquiring what they did).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// Copy one float from device memory to shared memory, asynchronously.
__device__ __forceinline__ void copy(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem(dst)), "l"(src)
               : "memory");
}

// Ask for the 128-byte line holding p to be brought into L2.
__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Close this thread's group of copies issued since the last one.
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// Wait until this thread's groups of copies have all landed, or all but
// the newest one.
__device__ __forceinline__ void wait_all() { asm volatile("cp.async.wait_group 0;" ::: "memory"); }
__device__ __forceinline__ void wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Store v at `slot` of block `rank` of the cluster (the same offset as
// `slot` in this block), completing 4 bytes on that block's `bar`.
__device__ __forceinline__ void send(float* slot, unsigned long long* bar, const unsigned rank,
                                     const float v) {
  unsigned remote_slot, remote_bar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote_slot) : "r"(smem(slot)),
               "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote_bar) : "r"(smem(bar)),
               "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(remote_slot), "r"(__float_as_uint(v)), "r"(remote_bar)
               : "memory");
}

}  // namespace async
}  // namespace lbm
