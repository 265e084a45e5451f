// The 64x64 window of the two temporal-block kernels (tblock_step.cu on
// the whole field, tblock_sharded_step.cu on one shard's carry): K fused
// pull steps per launch, float32, for Hopper.  Both kernels run this one
// routine; they differ only in their addressing policy (Addr, below), which
// says how a window row and column are found and to which global cell each
// window cell is keyed.
//
// Bound.  A launch reads the 9 f32 planes once and writes them once for K
// steps: 72/K B of device traffic per cell per step, against about 170
// floating-point operations per cell per step (about 450 instructions with
// the walls, the moments' divisions and the addressing).  At K = 5 the
// published peaks give 0.0180 ms per step at 2048^2 by bytes and 0.0107 ms
// by operations; the window recomputes its halo 64^2 / 54^2 = 1.40 times.
// On the card it runs near neither bound: 32 warps per SM, one cell's
// dependency chain each in flight, is what the register file holds (55
// registers a thread), and the load and store of a window stand before
// and after its compute (PERF.md, section 6).
//
// Design.  Each block owns a tile of (64 - 2K) x (64 - 2K) cells and
// stages the 64 x 64 window around it (a K-wide halo on all four sides),
// all 9 planes and a tenth of lid densities, in dynamic shared memory
// (160 KB), one block of 1024 threads per SM.
// * Every window cell is keyed to its global cell: its wall masks, the lid
//   momentum with its zero at the two corners, and its lid density follow
//   the wrapped global coordinates (Addr::gx, Addr::gy), so the window is
//   an exact periodic image of the domain around the tile, and after s
//   in-window steps every cell at least s from the window's edge is exact.
//   (The y wrap shows at the lid corners, so a wrapped row must evolve as
//   the row it mirrors.)
// * One buffer, no copy per step: streaming is a translation of each plane,
//   so plane k is stored cyclically shifted by s * (dx_k * 64 + dy_k) over
//   the flat window after s steps.  Window cell (i, j) then finds all 9 of
//   its gathered populations at fixed addresses of step s, and writes its 9
//   post-collision populations back to those same addresses; no two cells
//   share an address, so a step has no race and needs one __syncthreads().
//   At the window's edge the shift brings in values of other edge cells;
//   they reach at most s cells inward after s steps (the trapezoid).
// * The lid density is carried per window cell in the tenth plane, which
//   does not stream: a lid cell reads and writes only its own slot, so two
//   images of the lid row in one window never race, and a field smaller
//   than the window is served.
// * A window that holds no wall cell (most windows of a large field) runs
//   the steps without masks or lid densities.
// * Threads run along y (the contiguous axis), 32 consecutive cells of one
//   window row per warp: the window load and the own-cell store are
//   coalesced, and the shifted rows are free of bank conflicts.
//
// Addr supplies, for window row i and column j (0 <= i, j < 64):
// row_off(i) + col_off(j), the cell's offset in a plane of f and f_out;
// plane, the floats of a plane; gx(i) and gy(j), its global cell; gx0 and
// gy0, the global cell of window cell (0, 0) before wrapping; lid_in(i)
// and lid_out(i, rho), the lid density before and after; own_col(j); and
// len, the own rows [K, K + len).

#pragma once

#include <cuda_runtime.h>

#include "lbm_cell.cuh"

namespace lbm {
namespace window {

// v mod n for n > 0.  v lies within 64 of [0, n), so one step of n is
// enough for a field of 64 or more; the integer % (about 20 instructions on
// the card) runs only for a field smaller than the window.
__host__ __device__ __forceinline__ int wrap(int v, const int n) {
  v = v < 0 ? v + n : (v >= n ? v - n : v);
  if (v < 0 || v >= n) {
    v %= n;
    if (v < 0) v += n;
  }
  return v;
}

constexpr int kWin = 64;                   // window edge in cells, x and y
constexpr int kWinCells = kWin * kWin;     // a power of two
constexpr int kThreads = 1024;
constexpr size_t kSmemBytes = 10 * kWinCells * sizeof(float);
constexpr unsigned char kLeft = 1, kRight = 2;    // x keys of a window row
constexpr unsigned char kBottom = 1, kLid = 2;    // y keys of a window column

// Shared-memory offset of plane k's window cell c = i * kWin + j after s
// steps: the plane is shifted cyclically by s * (dx_k * kWin + dy_k) over
// the flat window.
__device__ __forceinline__ int slot(const int k, const int c, const int s) {
  return k * kWinCells + ((c - s * (dx(k) * kWin + dy(k))) & (kWinCells - 1));
}

template <bool kWalls>
__device__ __forceinline__ void window_steps(float* __restrict__ win,
                                             float* __restrict__ rl,
                                             const unsigned char* __restrict__ xkey,
                                             const unsigned char* __restrict__ ykey,
                                             const Params& p, const int k_steps) {
  for (int s = 1; s <= k_steps; ++s) {
    for (int c = threadIdx.x; c < kWinCells; c += kThreads) {
      float g[9], o[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) g[k] = win[slot(k, c, s)];
      if (kWalls) {
        const unsigned char col = xkey[c / kWin], row = ykey[c % kWin];
        const bool left = col & kLeft, right = col & kRight, lid = row & kLid;
        const float rlp = (lid && !(left || right)) ? rl[c] : 0.0f;
        const float rho = fused_cell(g, left, right, row & kBottom, lid, rlp, nullptr,
                                     p, o);
        if (lid) rl[c] = rho;
      } else {
        fused_cell(g, false, false, false, false, 0.0f, nullptr, p, o);
      }
#pragma unroll
      for (int k = 0; k < 9; ++k) win[slot(k, c, s)] = o[k];
    }
    __syncthreads();
  }
}

// One block's window: the tile whose window cell (0, 0) Addr describes.
template <class Addr>
__device__ __forceinline__ void window_block(const Addr& a, const float* __restrict__ f,
                                             float* __restrict__ f_out, const Params& p,
                                             const int k_steps) {
  extern __shared__ float win[];          // 9 planes of kWin x kWin
  float* const rl = win + 9 * kWinCells;  // lid density per window cell
  __shared__ int col_off[kWin];
  __shared__ unsigned char xkey[kWin], ykey[kWin];
  for (int i = threadIdx.x; i < kWin; i += kThreads) {
    const int gx = a.gx(i), gy = a.gy(i);
    col_off[i] = a.col_off(i);     // for the write-back
    xkey[i] = (gx == 0 ? kLeft : 0) | (gx == p.nx - 1 ? kRight : 0);
    ykey[i] = (gy == p.ny - 1 ? kBottom : 0) | (gy == 0 ? kLid : 0);
  }
  __syncthreads();
  // Stage the window (step 0 is stored unshifted) and the lid densities.
  // The staging loop reads no shared memory, so that, unrolled, all its
  // loads are in flight at once (an offset read from shared memory after a
  // store to the window would order them behind it).
#pragma unroll
  for (int c = threadIdx.x; c < kWinCells; c += kThreads) {
    const size_t src = a.row_off(c / kWin) + a.col_off(c % kWin);
#pragma unroll
    for (int k = 0; k < 9; ++k) win[k * kWinCells + c] = f[k * a.plane + src];
  }
  for (int c = threadIdx.x; c < kWinCells; c += kThreads) {
    if (ykey[c % kWin] & kLid) rl[c] = a.lid_in(c / kWin);   // only lid cells read it
  }
  __syncthreads();

  // Does the window (unwrapped) hold a cell of any wall?
  const bool walls = a.gx0 < 1 || a.gx0 + kWin > p.nx - 1 || a.gy0 < 1 ||
                     a.gy0 + kWin > p.ny - 1;
  if (walls) {
    window_steps<true>(win, rl, xkey, ykey, p, k_steps);
  } else {
    window_steps<false>(win, rl, xkey, ykey, p, k_steps);
  }

  // Write back the own cells (the last tile of a row or column may reach
  // past the field or shard).
  for (int c = threadIdx.x; c < kWinCells; c += kThreads) {
    const int i = c / kWin, j = c % kWin;
    if (i < k_steps || i >= k_steps + a.len || !a.own_col(j)) continue;
    const size_t dst = a.row_off(i) + col_off[j];
#pragma unroll
    for (int k = 0; k < 9; ++k) f_out[k * a.plane + dst] = win[slot(k, c, k_steps)];
    if (ykey[j] & kLid) a.lid_out(i, rl[c]);
  }
}

// Launch kernel(args...) on a grid of x tiles x y tiles, after asking for
// its shared memory.  Returns a cudaError_t as an int.
template <class Kernel, class... Args>
inline int launch(Kernel kernel, const int x_tiles, const int y_tiles,
                  cudaStream_t stream, Args... args) {
  if (y_tiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  // Above 48 KB, dynamic shared memory must be asked for (per device).
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<dim3(x_tiles, y_tiles), kThreads, kSmemBytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace window
}  // namespace lbm
