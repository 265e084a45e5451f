// An x-marching wavefront for the temporal-block kernel: K fused pull
// steps per launch, float32, for Hopper.  It is not part of the package:
// it was measured against the 64x64 window of
// latticeboltzmannsimulations_torch/csrc/tblock_window.cuh and found
// slower at every size (PERF.md, section 6), so the package keeps the
// window.  scripts/torch_tblock_designs.py builds it, from this directory
// and the package's lbm_cell.cuh, to check it bit for bit against
// pull_step and time it beside the window; tblock_march_step.cu is its
// single-device kernel, with the addressing policy of the package's
// tblock_step.cu (Addr, below).
//
// Bound.  A launch reads the 9 f32 planes once and writes them once for K
// steps: 72/K B of device traffic per cell per step, against about 170
// floating-point operations per cell per step.  At K = 5 the published
// peaks give 0.0180 ms per step at 2048^2 by bytes and 0.0107 ms by
// operations.
//
// Design.  Each block owns a strip of W - 2K cells of the y axis (y is
// contiguous in memory) and a segment of L rows of the x axis, and keeps
// a K-wide halo on all four sides.  It marches along x: at x-step t,
// level 0 (the input) receives window row t + kAhead by cp.async, and
// level s = 1..K computes step s of window row t - 2s from level s - 1's
// rows t - 2s - 1 .. t - 2s + 1.  Those rows were written in earlier
// x-steps (the skew of 2), so one __syncthreads() per x-step orders
// everything, and the levels may run in any order within an x-step (the
// serial CPU emulation runs them one after the other).  Level s keeps a
// ring of 4 rows (the row it writes and the three level s + 1 reads);
// level 0 a ring of kAhead + 4; level K writes the own cells straight to
// device memory.  Shared memory: W * (9 * (kAhead + 4) + 10 * 4 * (K - 1))
// floats, 59 KB at W = 64, K = 5, so several blocks share an SM and one
// block's loads and barriers overlap another's compute.
//
// * Level s computes only the window rows [s, rows - s) it is needed on,
//   so in x the edge is recomputed (L + K - 1) / L times; in y every level
//   computes all W cells (a warp's lanes run together), W / (W - 2K).
//   Within a row, the y neighbours wrap inside the strip: the wrap brings
//   in values of the other edge, which reach s cells inward after s steps
//   and never an own cell (the trapezoid).
// * Every window cell is keyed to its global cell: its wall masks, the lid
//   momentum with its zero at the two corners, and its lid density follow
//   the wrapped global coordinates, so the window is an exact periodic
//   image of the domain around the own cells.  (The y wrap shows at the lid
//   corners, so a wrapped row must evolve as the row it mirrors.)
// * The lid density is carried per level, row and cell, in a tenth plane
//   of each level's ring that does not stream: level s at row r reads what
//   level s - 1 wrote for row r (level 1 reads the input's), and a lid cell
//   reads and writes only its own slot, so two images of the lid row in
//   one strip do not race.  Only own cells of the global lid row write
//   their density out.
// * A block whose window holds no wall cell (most of a large field) runs
//   without masks or lid densities.
// * Level 0's rows arrive 4 x-steps ahead of use by 4-byte cp.async (the
//   window's rows wrap and start at any float, so 16-byte and bulk copies
//   would need aligned, unwrapped runs), one commit group per x-step;
//   the wait before each barrier leaves the next 4 rows in flight, so the
//   loads overlap the compute instead of standing before it.
// * The segment length L is chosen at launch: enough segments that the
//   grid fills every SM kWaves times with as many blocks as fit (occupancy
//   query), unless the caller fixes it.
//
// Sizing at W = 64, K = 5 with one wave (320 threads, 59 KB of shared
// memory, 3 blocks per SM if a thread takes at most 64 registers: 396
// slots on the 132 SMs), as worked out before the first run on the card;
// the recomputation is W / (W - 2K) in y times (L + K - 1) / L in x
// (the 64x64 window before it: 64^2 / 54^2 = 1.40):
//   field                  strips  segments x L  blocks  waves  recomputed
//   1024^2                   19       20 x 52      380   0.96   1.185 x 1.077 = 1.28
//   2048^2                   38       10 x 205     380   0.96   1.185 x 1.020 = 1.21
//   4096^2                   76        5 x 820     380   0.96   1.185 x 1.005 = 1.19
//   2048^2 shard (of 4096^2 on 2x2)  as 2048^2, one launch per shard
// Bound by bytes: 72/K = 14.4 B per cell per step, 0.0180 ms per step at
// 2048^2 at the published 3.35 TB/s.

#pragma once

#include <cuda_runtime.h>

#include "lbm_cell.cuh"

namespace lbm {
namespace march {

constexpr int kAhead = 4;            // rows of level 0 loaded ahead of use
constexpr int kRing0 = kAhead + 4;   // rows kept of level 0
constexpr int kRing = 4;             // rows kept of levels 1 .. K-1
constexpr int kThreads = 1024;       // most threads of a block
// Waves of blocks a launch is cut into by default: blocks near a wall take
// longer, and later waves even out the SMs' loads.
constexpr int kWaves = 3;

// Floats of dynamic shared memory for a strip of width w and K = k.
__host__ __device__ constexpr size_t smem_floats(const int w, const int k) {
  return static_cast<size_t>(w) * (9 * kRing0 + 10 * kRing * (k - 1));
}

// v mod n for n > 0, by steps of n: v is within K of [0, n) on the hot
// paths, so at most one step unless the field is smaller than K (an
// integer % costs about 20 instructions on the card).
__host__ __device__ __forceinline__ int wrap(int v, const int n) {
  while (v < 0) v += n;
  while (v >= n) v -= n;
  return v;
}

// 4 bytes from device memory into shared memory, asynchronously.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void copy_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Wait until at most kAhead of this thread's commit groups are pending.
__device__ __forceinline__ void copy_wait_ahead() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead) : "memory");
#endif
}

// One block's march.  Addr supplies, for window row r (0 <= r < rows) and
// window column j (0 <= j < W): row_off(r) + col_off(j), the offset of the
// cell in a plane of f and f_out; gx(r) and gy(j), its global cell;
// lid_in(r) and lid_out(r, rho), the lid density before and after; and
// own_col(j).  The own rows are [K, rows - K).
template <int W, bool kWalls, class Addr>
__device__ __forceinline__ void march_steps(const Addr& a, const float* __restrict__ f,
                                            float* __restrict__ f_out,
                                            const Params& p, const int k,
                                            float* __restrict__ ring0,
                                            float* __restrict__ ring,
                                            const int* __restrict__ col_off,
                                            const unsigned char* __restrict__ ykey) {
  constexpr unsigned char kBottom = 1, kLid = 2;
  const int rows = a.rows;
  const int cells = k * W;
  const int steps = rows + k;   // the last row of level K is done at rows + K - 1

  auto load_row = [&](const int r) {
    if (r < rows) {
      float* dst = ring0 + (r & (kRing0 - 1)) * 9 * W;
      const size_t base = a.row_off(r);
      for (int e = threadIdx.x; e < 9 * W; e += blockDim.x) {
        const int kk = e / W, j = e % W;
        copy_async(dst + e, f + kk * a.plane + base + col_off[j]);
      }
    }
    copy_commit();
  };
  for (int r = 0; r < kAhead; ++r) load_row(r);

  for (int t = 0; t < steps; ++t) {
    copy_wait_ahead();     // rows up to t - 1 have landed
    __syncthreads();       // and every level's rows of x-step t - 1 are written
    load_row(t + kAhead);
    for (int c = threadIdx.x; c < cells; c += blockDim.x) {
      const int s = c / W + 1, j = c % W;
      const int r = t - 2 * s;
      if (r < s || r >= rows - s) continue;
      // level s - 1's rows r - 1, r, r + 1
      const float* src;
      int pitch;   // floats from one row of the ring to the next
      int mask;    // rows of the ring - 1 (a power of two)
      if (s == 1) {
        src = ring0, pitch = 9 * W, mask = kRing0 - 1;
      } else {
        src = ring + (s - 2) * kRing * 10 * W, pitch = 10 * W, mask = kRing - 1;
      }
      float g[9], o[9];
#pragma unroll
      for (int kk = 0; kk < 9; ++kk) {
        g[kk] = src[((r - dx(kk)) & mask) * pitch + kk * W + ((j - dy(kk)) & (W - 1))];
      }
      float rho = 0.0f;
      bool lid = false;
      if (kWalls) {
        const int gx = a.gx(r);
        const bool left = gx == 0, right = gx == p.nx - 1;
        lid = ykey[j] & kLid;
        float rlp = 0.0f;
        if (lid && !(left || right)) {
          rlp = s == 1 ? a.lid_in(r) : src[(r & mask) * pitch + 9 * W + j];
        }
        rho = fused_cell(g, left, right, ykey[j] & kBottom, lid, rlp, nullptr, p, o);
      } else {
        fused_cell(g, false, false, false, false, 0.0f, nullptr, p, o);
      }
      if (s < k) {
        float* dst = ring + (s - 1) * kRing * 10 * W + (r & (kRing - 1)) * 10 * W + j;
#pragma unroll
        for (int kk = 0; kk < 9; ++kk) dst[kk * W] = o[kk];
        if (lid) dst[9 * W] = rho;
      } else if (a.own_col(j)) {
        const size_t at = a.row_off(r) + col_off[j];
#pragma unroll
        for (int kk = 0; kk < 9; ++kk) f_out[kk * a.plane + at] = o[kk];
        if (lid) a.lid_out(r, rho);
      }
    }
  }
}

template <int W, class Addr>
__device__ __forceinline__ void march_block(const Addr& a, const float* __restrict__ f,
                                            float* __restrict__ f_out,
                                            const Params& p, const int k) {
  extern __shared__ float smem[];
  __shared__ int col_off[W];
  __shared__ unsigned char ykey[W];
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    const int gy = a.gy(j);
    col_off[j] = a.col_off(j);
    ykey[j] = (gy == p.ny - 1 ? 1 : 0) | (gy == 0 ? 2 : 0);
  }
  __syncthreads();
  float* const ring = smem + kRing0 * 9 * W;
  // Does the window (global rows gx0 .. gx0 + rows - 1, columns gy0 ..
  // gy0 + W - 1, unwrapped) hold a cell of any wall?
  const bool walls = a.gx0 < 1 || a.gx0 + a.rows > p.nx - 1 || a.gy0 < 1 ||
                     a.gy0 + W > p.ny - 1;
  if (walls) {
    march_steps<W, true>(a, f, f_out, p, k, smem, ring, col_off, ykey);
  } else {
    march_steps<W, false>(a, f, f_out, p, k, smem, ring, col_off, ykey);
  }
}

// Threads of a block for width w and K = k: one per cell of a row of each
// level, at most kThreads.
inline int block_threads(const int w, const int k) {
  return w * k < kThreads ? w * k : kThreads;
}

// Launch kernel(args..., seg) on a grid of strips x segments of seg rows
// (of total_rows), after asking for its shared memory.  seg is seg_rows if
// positive, else the length for which strips x segments blocks fill every
// SM kWaves times (at most) with as many blocks as fit (at least one
// segment).  Returns a cudaError_t as an int.
template <class Kernel, class... Args>
inline int launch(Kernel kernel, const int w, const int k, const int strips,
                  const int total_rows, const int seg_rows, cudaStream_t stream,
                  Args... args) {
  const size_t bytes = smem_floats(w, k) * sizeof(float);
  const int threads = block_threads(w, k);
  // Above 48 KB, dynamic shared memory must be asked for (per device).
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  // As much of the SM's memory for shared memory as it can take, so that
  // several blocks fit.
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             static_cast<int>(cudaSharedmemCarveoutMaxShared));
  }
  int seg = seg_rows;
  if (seg <= 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes);
    }
    const long long slots = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    long long segs = kWaves * slots / strips;
    segs = segs < 1 ? 1 : (segs > total_rows ? total_rows : segs);
    seg = static_cast<int>((total_rows + segs - 1) / segs);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int segments = (total_rows + seg - 1) / seg;
  if (segments > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<dim3(strips, segments), threads, bytes, stream>>>(args..., seg);
  return static_cast<int>(cudaGetLastError());
}

// The strip widths the kernel is built for, and the K each can take.
inline bool fits(const int w, const int k) {
  return (w == 64 || w == 128) && k >= 1 && 2 * k < w &&
         smem_floats(w, k) * sizeof(float) <= 232448;
}

}  // namespace march
}  // namespace lbm
