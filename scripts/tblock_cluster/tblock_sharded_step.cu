// Temporal-block fused pull step of one shard of the D2Q9 lid-driven cavity,
// float32, for Hopper: K fused pull steps per launch on one shard (built for
// sm_90a with kernels/_build.py's flags and bound through ctypes by
// scripts/torch_tblock_designs.py; a measured design, not part of the
// package, whose csrc/tblock_sharded_step.cu runs the 64 x 64 window).
//
// A design for the TPU kernel of the JAX package:
//   kernels/pallas_pull_tblock_sharded.py::_make_kernel (:57), launched by
//   the pl.pallas_call at :246 inside make_sharded_tblock_runner (:175).
// It computes exactly K steps of parallel/halo.py's sharded fused step (no
// Van Driest plane) on one shard, whose neighbours arrive once per K steps
// in a K-deep halo ring.
//
// Bound and design: tblock_window.cuh, the cluster window this kernel
// shares with tblock_step.cu; the exchange between launches (tensor copies
// made by the wrapper, or halo_exchange.cu) moves K-deep strips once per K
// steps instead of one-cell strips every step.  Here a window row is a row
// of the shard's carry:
// * The carry is (9, lx + 2K, ly + 2K), y contiguous, the shard's cells at
//   [K, K + lx) x [K, K + ly), the ring filled by the exchange (y and x
//   strips and the corners).  The window of cluster (ux, uy) reads its cell
//   (I, J) from carry cell (ux (R Cx - 2K) + I, uy (C Cy - 2K) + J); cells
//   past the carry's edge (the last clusters of a shard that is no multiple
//   of the cluster's tile, or a shard narrower than the window) read the
//   nearest carry cell: the last own cell of a row is carry cell lx + K - 1
//   and the first one past the edge lx + 2K, so they lie more than K cells
//   from every own cell, and what they compute never reaches one.
// * Every window cell is keyed to its global content cell
//   ((x_off + ux (R Cx - 2K) - K + I) mod nx,
//   (y_off + uy (C Cy - 2K) - K + J) mod ny):
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

// Part addressing of one block on the shard's carry.
struct Carry {
  const float* panel;
  float* panel_out;
  int nx, ny;
  size_t plane;
  int gx0, gy0;            // global cell of part cell (0, 0), unwrapped
  int row_lo, row_hi;      // own rows of the part
  int col_lo, col_hi;      // own columns of the part
  int cx0, cy0;            // carry cell of part cell (0, 0)
  int px, py;              // carry rows and columns

  __device__ int gx(const int i) const { return wrap(gx0 + i, nx); }
  __device__ int gy(const int j) const { return wrap(gy0 + j, ny); }
  // Rows and columns past the carry's edge read the nearest carry cell.
  __device__ int cx(const int i) const { return max(0, min(cx0 + i, px - 1)); }
  __device__ size_t row_off(const int i) const { return static_cast<size_t>(cx(i)) * py; }
  __device__ int col_off(const int j) const { return max(0, min(cy0 + j, py - 1)); }
  __device__ const float* lid_src(const int i) const { return panel + cx(i); }
  __device__ void lid_out(const int i, const float rho) const { panel_out[cx(i)] = rho; }
};

// The shard's tiles, ux x uy, each a cluster's own cells.
template <int R>
struct CarryTiles {
  const float* panel;
  float* panel_out;
  Shard sh;
  int nx, ny, k, own_x, own_y, uy, count;

  __device__ Carry at(const int tile, const lbm::window::Part& part) const {
    constexpr int C = lbm::window::kCells / R;
    const int px = sh.lx + 2 * k, py = sh.ly + 2 * k;
    // The cluster's first own cell in the shard's cells; its window cell
    // (0, 0) is carry cell (x0, y0).
    const int x0 = (tile / uy) * own_x, y0 = (tile % uy) * own_y;
    const int ox = R * part.rx, oy = C * part.ry;
    const auto rows = lbm::window::own_range(k, own_x, x0, sh.lx, part.rx, R);
    const auto cols = lbm::window::own_range(k, own_y, y0, sh.ly, part.ry, C);
    return Carry{panel, panel_out, nx, ny, static_cast<size_t>(px) * py,
                 sh.x_off + x0 - k + ox, sh.y_off + y0 - k + oy, rows.lo, rows.hi, cols.lo,
                 cols.hi, x0 + ox, y0 + oy, px, py};
  }
};

template <int R>
__global__ void __launch_bounds__(lbm::window::kThreads, 1)
tblock_sharded_step_kernel(const float* __restrict__ f, float* __restrict__ f_out,
                           const CarryTiles<R> tiles, const Params p, const int k) {
  lbm::window::window_run<R>(tiles, f, f_out, p, k);
}

template <int R>
int run(const void* f, const void* panel, void* f_out, void* panel_out, const Params& p,
        const Shard& sh, const int k, const int cx, const int cy, cudaStream_t stream) {
  constexpr int C = lbm::window::kCells / R;
  const int own_x = R * cx - 2 * k, own_y = C * cy - 2 * k;
  const int ux = (sh.lx + own_x - 1) / own_x, uy = (sh.ly + own_y - 1) / own_y;
  const CarryTiles<R> tiles{static_cast<const float*>(panel), static_cast<float*>(panel_out),
                            sh, p.nx, p.ny, k, own_x, own_y, uy, ux * uy};
  return lbm::window::launch<R>(tblock_sharded_step_kernel<R>, cx, cy, ux * uy, stream,
                                static_cast<const float*>(f), static_cast<float*>(f_out),
                                tiles, p, k);
}

}  // namespace

// K = k_steps fused steps of one shard on `stream`: the carry f
// (9, lx + 2K, ly + 2K) with its halo ring filled and the lid-density panel
// (lx + 2K,) with its x halo filled -> the shard's cells of f_out (same
// shape) and, on a shard that owns the lid, the shard's cells of panel_out;
// as clusters of cluster_x x cluster_y blocks of `rows` part rows each.
// (x_off, y_off) is the global coordinate of the shard's first cell; nx, ny
// and the scalars after them are kernels/pull.py::_scalars of the global
// grid.  Requires a shape that window::shape_ok takes, lx, ly >= k_steps
// and no Van Driest plane (the wrapper checks).  Returns cudaGetLastError() after the launch.
extern "C" int lbm_tblock_sharded_step(
    const void* f, const void* panel, void* f_out, void* panel_out, int lx,
    int ly, int x_off, int y_off, int nx, int ny, float u_lid, float lid_mom,
    float omega, float tau0, float tau0_sq, float omega_minus, float omega_e,
    float omega_eps, float omega_q, int collision, int les, float smag_coef,
    int k_steps, int rows, int cluster_x, int cluster_y, void* stream) {
  const Params p{nx, ny, u_lid, lid_mom, omega, tau0, tau0_sq, omega_minus,
                 omega_e, omega_eps, omega_q, collision, les, smag_coef};
  const Shard sh{lx, ly, x_off, y_off};
  if (!lbm::window::shape_ok(rows, cluster_x, cluster_y, k_steps) || lx < k_steps ||
      ly < k_steps || les == lbm::LES_PLANE) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 64: return run<64>(f, panel, f_out, panel_out, p, sh, k_steps,
                            cluster_x, cluster_y, s);
    case 32: return run<32>(f, panel, f_out, panel_out, p, sh, k_steps,
                            cluster_x, cluster_y, s);
    default: return run<16>(f, panel, f_out, panel_out, p, sh, k_steps,
                           cluster_x, cluster_y, s);
  }
}
