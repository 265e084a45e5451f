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
// Bound and design: tblock_window.cuh, the 64x64 window this kernel shares
// with tblock_sharded_step.cu.  Here a window row is a wrapped global row of
// the field: window cell (i, j) of the tile (bx, by) is global cell
// ((bx (64 - 2K) - K + i) mod nx, (by (64 - 2K) - K + j) mod ny), so a
// field of any size (even smaller than the window) is served.  The input
// and the output are two buffers: blocks read their windows' halos while
// others write.

#include <cuda_runtime.h>

#include "tblock_window.cuh"

namespace {

using lbm::Params;
using lbm::window::wrap;

// Window addressing of one block on the whole field.
struct Field {
  const float* rho_lid_prev;
  float* rho_lid_out;
  int nx, ny;
  size_t plane;
  int gx0, gy0;    // global cell of window cell (0, 0), unwrapped
  int k, own;      // K, own cells of a tile's side
  int len;         // own rows: window rows [K, K + len)

  __device__ int gx(const int i) const { return wrap(gx0 + i, nx); }
  __device__ int gy(const int j) const { return wrap(gy0 + j, ny); }
  __device__ size_t row_off(const int i) const { return static_cast<size_t>(gx(i)) * ny; }
  __device__ int col_off(const int j) const { return gy(j); }
  __device__ float lid_in(const int i) const { return rho_lid_prev[gx(i)]; }
  __device__ void lid_out(const int i, const float rho) const { rho_lid_out[gx(i)] = rho; }
  // An own column inside the field (the last tile may reach past it).
  __device__ bool own_col(const int j) const {
    return j >= k && j < k + own && gy0 + j < ny;
  }
};

__global__ void __launch_bounds__(lbm::window::kThreads, 1)
tblock_step_kernel(const float* __restrict__ f, const float* __restrict__ rho_lid_prev,
                   float* __restrict__ f_out, float* __restrict__ rho_lid_out,
                   const Params p, const int k) {
  const int own = lbm::window::kWin - 2 * k;
  const int x0 = blockIdx.x * own, y0 = blockIdx.y * own;   // first own cell
  const Field a{rho_lid_prev, rho_lid_out, p.nx, p.ny, static_cast<size_t>(p.nx) * p.ny,
                x0 - k, y0 - k, k, own, min(own, p.nx - x0)};
  lbm::window::window_block(a, f, f_out, p, k);
}

}  // namespace

// K = k_steps fused steps (f, rho_lid_prev) -> (f_out, rho_lid_out) in one
// launch on `stream`.  Pointers are device pointers to contiguous float32
// buffers; the output must not alias the input.  Requires 1 <= k_steps,
// 2 * k_steps < 64, and at most 65535 tiles along y (the wrapper checks).
// Returns cudaGetLastError() after the launch.
extern "C" int lbm_tblock_step(const void* f, const void* rho_lid_prev,
                               void* f_out, void* rho_lid_out, int nx, int ny,
                               float u_lid, float lid_mom, float omega,
                               float tau0, float tau0_sq, float omega_minus,
                               float omega_e, float omega_eps, float omega_q,
                               int collision, int les, float smag_coef,
                               int k_steps, void* stream) {
  const Params p{nx, ny, u_lid, lid_mom, omega, tau0, tau0_sq, omega_minus,
                 omega_e, omega_eps, omega_q, collision, les, smag_coef};
  if (k_steps < 1 || 2 * k_steps >= lbm::window::kWin || nx < 1 || ny < 1 ||
      les == lbm::LES_PLANE) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int own = lbm::window::kWin - 2 * k_steps;
  return lbm::window::launch(tblock_step_kernel, (nx + own - 1) / own, (ny + own - 1) / own,
                             static_cast<cudaStream_t>(stream), static_cast<const float*>(f),
                             static_cast<const float*>(rho_lid_prev),
                             static_cast<float*>(f_out), static_cast<float*>(rho_lid_out),
                             p, k_steps);
}
