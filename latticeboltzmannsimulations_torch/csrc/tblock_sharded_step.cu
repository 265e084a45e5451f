// Temporal-block fused pull step of one shard of the D2Q9 lid-driven cavity,
// float32, for Hopper: K fused pull steps per launch on one shard (built for
// sm_90a by kernels/_build.py with nvcc, bound through ctypes by
// kernels/tblock_sharded.py).
//
// Replaces the TPU kernel of the JAX package:
//   kernels/pallas_pull_tblock_sharded.py::_make_kernel (:57), launched by
//   the pl.pallas_call at :246 inside make_sharded_tblock_runner (:175).
// It computes exactly K steps of parallel/halo.py's sharded fused step (no
// Van Driest plane) on one shard, whose neighbours arrive once per K steps
// in a K-deep halo ring.
//
// Bound and design: tblock_window.cuh, the 64x64 window this kernel shares
// with tblock_step.cu; the exchange between launches (tensor copies made by
// the wrapper, or halo_exchange.cu) moves K-deep strips once per K steps
// instead of one-cell strips every step.  Here a window row is a row of the
// shard's carry:
// * The carry is (9, lx + 2K, ly + 2K), y contiguous, the shard's cells at
//   [K, K + lx) x [K, K + ly), the ring filled by the exchange (y and x
//   strips and the corners).  The block of tile (bx, by)
//   reads window cell (i, j) from carry cell (bx (64 - 2K) + i,
//   by (64 - 2K) + j); cells past the carry's edge (the last tiles of a
//   shard that is no multiple of the tile, or a shard narrower than the
//   window) read the nearest carry cell: they lie more than K cells from
//   every own cell, so what they compute never reaches one.
// * Every window cell is keyed to its global content cell
//   ((x_off + bx (64 - 2K) - K + i) mod nx,
//   (y_off + by (64 - 2K) - K + j) mod ny):
//   the halo ring holds the periodic images of the neighbours (the wrap of
//   the edge shards), so the window is an exact image of the domain around
//   the own cells.  (The JAX kernel keys x to a global offset and y to the
//   content rows of its halo lanes, which this one rule covers.)
// * The lid density starts from the shard's lid-density panel (lx + 2K,),
//   whose x halo rides the same exchange; only the cells of the global lid
//   row that the shard owns write their densities back.

#include <cuda_runtime.h>

#include "tblock_window.cuh"

namespace {

using lbm::Params;
using lbm::window::wrap;

// The shard within the global grid.
struct Shard {
  int lx, ly;          // the shard's cells
  int x_off, y_off;    // global coordinates of its first cell
};

// Window addressing of one block on the shard's carry.
struct Carry {
  const float* panel;
  float* panel_out;
  int nx, ny;
  size_t plane;
  int gx0, gy0;    // global cell of window cell (0, 0), unwrapped
  int k, own;      // K, own cells of a tile's side
  int len;         // own rows: window rows [K, K + len)
  int cx0, cy0;    // carry cell of window cell (0, 0)
  int px, py, ly;  // carry rows and columns, shard columns

  __device__ int gx(const int i) const { return wrap(gx0 + i, nx); }
  __device__ int gy(const int j) const { return wrap(gy0 + j, ny); }
  // Rows and columns past the carry's edge read the nearest carry cell.
  __device__ int cx(const int i) const { return min(cx0 + i, px - 1); }
  __device__ size_t row_off(const int i) const { return static_cast<size_t>(cx(i)) * py; }
  __device__ int col_off(const int j) const { return min(cy0 + j, py - 1); }
  __device__ float lid_in(const int i) const { return panel[cx(i)]; }
  __device__ void lid_out(const int i, const float rho) const { panel_out[cx(i)] = rho; }
  // An own column inside the shard (the last tile may reach past it).
  __device__ bool own_col(const int j) const {
    return j >= k && j < k + own && cy0 + j < ly + k;
  }
};

__global__ void __launch_bounds__(lbm::window::kThreads, 1)
tblock_sharded_step_kernel(const float* __restrict__ f, const float* __restrict__ panel,
                           float* __restrict__ f_out, float* __restrict__ panel_out,
                           const Params p, const Shard sh, const int k) {
  const int own = lbm::window::kWin - 2 * k;
  const int px = sh.lx + 2 * k, py = sh.ly + 2 * k;
  // The tile's first own cell in the shard's cells; window cell (0, 0) is
  // carry cell (x0, y0).
  const int x0 = blockIdx.x * own, y0 = blockIdx.y * own;
  const Carry a{panel, panel_out, p.nx, p.ny, static_cast<size_t>(px) * py,
                sh.x_off + x0 - k, sh.y_off + y0 - k, k, own, min(own, sh.lx - x0),
                x0, y0, px, py, sh.ly};
  lbm::window::window_block(a, f, f_out, p, k);
}

}  // namespace

// K = k_steps fused steps of one shard on `stream`: the carry f
// (9, lx + 2K, ly + 2K) with its halo ring filled and the lid-density panel
// (lx + 2K,) with its x halo filled -> the shard's cells of f_out (same
// shape) and, on a shard that owns the lid, the shard's cells of panel_out.
// (x_off, y_off) is the global coordinate of the shard's first cell; nx, ny
// and the scalars after them are kernels/pull.py::_scalars of the global
// grid.  Requires 1 <= k_steps, 2 * k_steps < 64, lx, ly >= k_steps, no
// Van Driest plane, and at most 65535 tiles along y (the wrapper checks).
// Returns cudaGetLastError() after the launch.
extern "C" int lbm_tblock_sharded_step(
    const void* f, const void* panel, void* f_out, void* panel_out, int lx,
    int ly, int x_off, int y_off, int nx, int ny, float u_lid, float lid_mom,
    float omega, float tau0, float tau0_sq, float omega_minus, float omega_e,
    float omega_eps, float omega_q, int collision, int les, float smag_coef,
    int k_steps, void* stream) {
  const Params p{nx, ny, u_lid, lid_mom, omega, tau0, tau0_sq, omega_minus,
                 omega_e, omega_eps, omega_q, collision, les, smag_coef};
  const Shard sh{lx, ly, x_off, y_off};
  if (k_steps < 1 || 2 * k_steps >= lbm::window::kWin || lx < k_steps || ly < k_steps ||
      les == lbm::LES_PLANE) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int own = lbm::window::kWin - 2 * k_steps;
  return lbm::window::launch(tblock_sharded_step_kernel, (lx + own - 1) / own,
                             (ly + own - 1) / own, static_cast<cudaStream_t>(stream),
                             static_cast<const float*>(f), static_cast<const float*>(panel),
                             static_cast<float*>(f_out), static_cast<float*>(panel_out), p,
                             sh, k_steps);
}
