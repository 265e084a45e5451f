// Temporal-block fused pull step of the D2Q9 lid-driven cavity, float32, for
// Hopper: K fused pull steps per launch (built for sm_90a by
// kernels/_build.py with nvcc, bound through ctypes by kernels/tblock.py).
//
// Replaces the TPU kernel of the JAX package:
//   kernels/pallas_pull_tblock.py::_make_kernel (:72), built by
//   make_block_step (:173), launched by the pl.pallas_call at :201.
// It computes exactly K steps of engine.make_fused_step for boundary="nebb"
// (no Van Driest plane): (f, rho_lid) -> (f', rho_lid') after K steps.
//
// Bound: a launch reads the 9 f32 planes once and writes them once for K
// steps, 72/K B of device traffic per cell per step, against about 170
// floating-point operations per cell per step (with the IEEE divisions of
// lbm_cell.cuh, about 300 instructions).  From K = 8 the published peaks
// put the two bounds level (2.8 us and 2.7 us per step at 1024^2); on the
// card the kernel is bound by instruction issue, and the halo it recomputes
// costs (64 / (64 - 2K))^2 of the operations, so a small K is best
// (chip_smoke.py times K = 4, 5, 8 and 16: PERF.md).
//
// Design.  Each block owns a tile of (64 - 2K) x (64 - 2K) cells and stages
// a 64 x 64 window around it (a K-wide halo on all four sides), all 9
// planes, in dynamic shared memory (147 712 B with the lid densities), one
// block of 1024 threads per SM: 32 warps to hide the latency of a long
// per-cell dependency chain.  (512 threads, and windows of 56 or 48 cells
// with two blocks per SM, measured slower.)
//
// * The window is wrap-consistent: window cell (i, j) is global cell
//   ((x0 - K + i) mod nx, (y0 - K + j) mod ny); its wall masks, the lid
//   momentum term with its zero at the two corners, and its lid density are
//   keyed to that global cell.  The window is then an exact periodic image
//   of the domain, so after s in-window steps every cell at least s from the
//   window's edge is exact, whatever the walls do, and the own cells are
//   exact after K steps.  (The TPU kernel instead relies on the walls
//   rewriting every population that crosses a domain edge, with y whole in
//   its window; that does not hold for a window tiled in y, because the wrap
//   value is visible at the lid corners.)  Fields smaller than the window are
//   refused by the wrapper, so no window holds two images of one cell.
// * One buffer, no copy per step: streaming is a translation of each plane,
//   so plane k is stored cyclically shifted by s * (dx_k * 64 + dy_k) over
//   the flat window after s steps.  Window cell (i, j) then finds all 9 of
//   its gathered populations at fixed addresses of step s, and writes its 9
//   post-collision populations back to those same addresses; no two cells
//   share an address, so a step has no race and needs one __syncthreads().
//   At the window's edge the shift brings in values of other edge cells;
//   they reach at most s cells inward after s steps (the trapezoid).
// * A window that holds no wall cell (most windows of a large field) runs
//   the steps without masks or lid densities.
// * rho_lid: the lid cell of window column i reads the previous step's lid
//   density from the shared array and writes its own back; one cell per
//   column does so, so there is no race.  Only the tile that owns global
//   row 0 writes its own columns back to rho_lid_out.
// * Threads run along y (the contiguous axis), 32 consecutive cells of one
//   window row per warp: the window load and the own-cell store are
//   coalesced, and the shifted shared-memory rows are free of bank
//   conflicts.

#include <cuda_runtime.h>

#include "lbm_cell.cuh"

namespace {

using lbm::Params;

constexpr int kWin = 64;                   // window edge in cells, x and y
constexpr int kWinCells = kWin * kWin;     // a power of two
constexpr int kThreads = 1024;
constexpr size_t kSmemBytes = (9 * kWinCells + kWin) * sizeof(float);

__device__ __forceinline__ int wrap(const int v, const int n) {
  // v lies in [-n, 2n): one correction is enough.
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

// Shared-memory offset of plane k's window cell c = i * kWin + j after s
// steps: the plane is shifted cyclically by s * (dx_k * kWin + dy_k) over
// the flat window.  For a cell off the window's edge this is its
// neighbour's offset of the step before; for an edge cell it is some other
// edge cell's, which is as good as any (the edge is not exact).
__device__ __forceinline__ int slot(const int k, const int c, const int s) {
  return k * kWinCells + ((c - s * (lbm::dx(k) * kWin + lbm::dy(k))) & (kWinCells - 1));
}

// The in-window steps of one thread's cells.  kWalls is false for a window
// that holds no wall cell (most of a large field): then the masks and the
// lid density are never needed.
template <bool kWalls>
__device__ __forceinline__ void window_steps(float* __restrict__ win,
                                             float* __restrict__ rl,
                                             const Params& p, const int wx,
                                             const int wy, const int k_steps) {
  for (int s = 1; s <= k_steps; ++s) {
    for (int c = threadIdx.x; c < kWinCells; c += kThreads) {
      float g[9], o[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) g[k] = win[slot(k, c, s)];
      if (kWalls) {
        const int i = c / kWin;
        const int gx = wrap(wx + i, p.nx), gy = wrap(wy + c % kWin, p.ny);
        const bool left = gx == 0, right = gx == p.nx - 1, lid = gy == 0;
        const float rlp = (lid && !(left || right)) ? rl[i] : 0.0f;
        const float rho = lbm::fused_cell(g, left, right, gy == p.ny - 1, lid,
                                          rlp, nullptr, p, o);
        if (lid) rl[i] = rho;
      } else {
        lbm::fused_cell(g, false, false, false, false, 0.0f, nullptr, p, o);
      }
#pragma unroll
      for (int k = 0; k < 9; ++k) win[slot(k, c, s)] = o[k];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 1)
tblock_step_kernel(const float* __restrict__ f,
                   const float* __restrict__ rho_lid_prev,
                   float* __restrict__ f_out,
                   float* __restrict__ rho_lid_out,
                   const Params p, const int k_steps) {
  extern __shared__ float win[];          // 9 planes of kWin x kWin
  float* const rl = win + 9 * kWinCells;  // lid density per window column
  const int nx = p.nx, ny = p.ny;
  const size_t plane = (size_t)nx * ny;
  const int own = kWin - 2 * k_steps;
  const int ox = blockIdx.x * own, oy = blockIdx.y * own;  // first own cell
  const int wx = ox - k_steps, wy = oy - k_steps;          // window origin

  // Stage the window: step 0 is stored unshifted.
  for (int c = threadIdx.x; c < kWinCells; c += kThreads) {
    const int i = c / kWin, j = c % kWin;
    const size_t src = (size_t)wrap(wx + i, nx) * ny + wrap(wy + j, ny);
#pragma unroll
    for (int k = 0; k < 9; ++k) win[k * kWinCells + c] = f[k * plane + src];
  }
  for (int i = threadIdx.x; i < kWin; i += kThreads) {
    rl[i] = rho_lid_prev[wrap(wx + i, nx)];
  }
  __syncthreads();

  // Does the window (columns wx .. wx + kWin - 1 and rows wy .. wy + kWin - 1,
  // wrapped) hold a cell of any wall?
  const bool walls = wx < 1 || wx + kWin > nx - 1 || wy < 1 || wy + kWin > ny - 1;
  if (walls) {
    window_steps<true>(win, rl, p, wx, wy, k_steps);
  } else {
    window_steps<false>(win, rl, p, wx, wy, k_steps);
  }

  // Write back the own cells that lie in the domain (the last tile of a
  // row or column may reach past it).
  for (int c = threadIdx.x; c < kWinCells; c += kThreads) {
    const int i = c / kWin, j = c % kWin;
    const int gx = wx + i, gy = wy + j;
    if (i < k_steps || i >= k_steps + own || j < k_steps || j >= k_steps + own ||
        gx >= nx || gy >= ny) {
      continue;
    }
    const size_t dst = (size_t)gx * ny + gy;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      f_out[k * plane + dst] = win[slot(k, c, k_steps)];
    }
    if (gy == 0) rho_lid_out[gx] = rl[i];
  }
}

}  // namespace

// K = k_steps fused steps (f, rho_lid_prev) -> (f_out, rho_lid_out) in one
// launch on `stream`.  Pointers are device pointers to contiguous float32
// buffers; the output must not alias the input.  Requires 1 <= k_steps,
// 2 * k_steps < 64, nx, ny >= 64 and at most 65535 tiles along y (the
// wrapper checks).  Returns
// cudaGetLastError() after the launch.
extern "C" int lbm_tblock_step(const void* f, const void* rho_lid_prev,
                               void* f_out, void* rho_lid_out, int nx, int ny,
                               float u_lid, float lid_mom, float omega,
                               float tau0, float tau0_sq, float omega_minus,
                               float omega_e, float omega_eps, float omega_q,
                               int collision, int les, float smag_coef,
                               int k_steps, void* stream) {
  const Params p{nx, ny, u_lid, lid_mom, omega, tau0, tau0_sq, omega_minus,
                 omega_e, omega_eps, omega_q, collision, les, smag_coef};
  if (k_steps < 1 || 2 * k_steps >= kWin || nx < kWin || ny < kWin ||
      les == lbm::LES_PLANE) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int own = kWin - 2 * k_steps;
  const dim3 grid((nx + own - 1) / own, (ny + own - 1) / own);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  // Above 48 KB, dynamic shared memory must be asked for (per device).
  const cudaError_t attr = cudaFuncSetAttribute(
      tblock_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  tblock_step_kernel<<<grid, kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<const float*>(rho_lid_prev),
      static_cast<float*>(f_out), static_cast<float*>(rho_lid_out), p,
      k_steps);
  return static_cast<int>(cudaGetLastError());
}
