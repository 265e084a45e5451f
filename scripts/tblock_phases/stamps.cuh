// Phase stamps for a scratch build of a temporal-block window (not part of
// the package): scripts/torch_tblock_designs.py compiles tblock_step.cu and
// tblock_sharded_step.cu with "-include stamps.cuh
// -DLBM_STAMP_SETTER=<name>", so that the window's LBM_WINDOW_STAMP(n)
// hooks (the cluster design's, scripts/tblock_cluster/tblock_window.cuh;
// inserted into a copy of the package's csrc/tblock_window.cuh, which has
// none) write, for each block, the SM's
// clock64() and the global %globaltimer at the start (n = 0), after the
// staging (1), after step s (1 + s) and after the write-back (K + 2).
// Each hook first waits for the whole block, so a stamp closes a phase for
// all of the block's threads.  The setter names the buffer (null: off):
// kStampSlots slots of two u64 per block, blocks in launch order
// (blockIdx.y * gridDim.x + blockIdx.x).

#pragma once

#include <cuda_runtime.h>

constexpr int kStampSlots = 40;

static __device__ unsigned long long* lbm_stamp_buffer;

extern "C" int LBM_STAMP_SETTER(void* buffer) {
  return static_cast<int>(cudaMemcpyToSymbol(lbm_stamp_buffer, &buffer, sizeof(buffer)));
}

__device__ __forceinline__ void lbm_window_stamp(const int n) {
  __syncthreads();
  unsigned long long* const out = lbm_stamp_buffer;
  if (threadIdx.x == 0 && out != nullptr && n < kStampSlots) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    const size_t at = (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * kStampSlots + n;
    out[2 * at] = t;
    out[2 * at + 1] = clock64();
  }
}

#define LBM_WINDOW_STAMP(n) lbm_window_stamp(n)
