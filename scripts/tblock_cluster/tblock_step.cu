// Temporal-block fused pull step of the D2Q9 lid-driven cavity, float32, for
// Hopper: K fused pull steps per launch (built for sm_90a with
// kernels/_build.py's flags and bound through ctypes by
// scripts/torch_tblock_designs.py; a measured design, not part of the
// package, whose csrc/tblock_step.cu runs the 64 x 64 window).
//
// A design for the TPU kernel of the JAX package:
//   kernels/pallas_pull_tblock.py::_make_kernel (:72), built by
//   make_block_step (:173), launched by the pl.pallas_call at :201.
// It computes exactly K steps of engine.make_fused_step for boundary="nebb"
// (no Van Driest plane): (f, rho_lid) -> (f', rho_lid') after K steps.
//
// Bound and design: tblock_window.cuh, the cluster window this kernel
// shares with tblock_sharded_step.cu.  Here a window row is a wrapped
// global row of the field: cell (I, J) of the window of cluster (ux, uy) is
// global cell ((ux (R Cx - 2K) - K + I) mod nx, (uy (C Cy - 2K) - K + J)
// mod ny), so a field of any size (even smaller than the window) is served.
// The input and the output are two buffers: blocks read their windows'
// halos while others write.

#include <cuda_runtime.h>

#include "tblock_window.cuh"

namespace {

using lbm::Params;
using lbm::window::wrap;

// Part addressing of one block on the whole field.
struct Field {
  const float* rho_lid_prev;
  float* rho_lid_out;
  int nx, ny;
  size_t plane;
  int gx0, gy0;            // global cell of part cell (0, 0), unwrapped
  int row_lo, row_hi;      // own rows of the part
  int col_lo, col_hi;      // own columns of the part

  __device__ int gx(const int i) const { return wrap(gx0 + i, nx); }
  __device__ int gy(const int j) const { return wrap(gy0 + j, ny); }
  __device__ size_t row_off(const int i) const { return static_cast<size_t>(gx(i)) * ny; }
  __device__ int col_off(const int j) const { return gy(j); }
  __device__ const float* lid_src(const int i) const { return rho_lid_prev + gx(i); }
  __device__ void lid_out(const int i, const float rho) const { rho_lid_out[gx(i)] = rho; }
};

// The field's tiles, ux x uy, each a cluster's own cells (row-major, so
// that clusters at once step neighbouring tiles).
template <int R>
struct FieldTiles {
  const float* rho_lid_prev;
  float* rho_lid_out;
  int nx, ny, k, own_x, own_y, uy, count;

  __device__ Field at(const int tile, const lbm::window::Part& part) const {
    constexpr int C = lbm::window::kCells / R;
    // the cluster's first own cell
    const int x0 = (tile / uy) * own_x, y0 = (tile % uy) * own_y;
    const auto rows = lbm::window::own_range(k, own_x, x0, nx, part.rx, R);
    const auto cols = lbm::window::own_range(k, own_y, y0, ny, part.ry, C);
    return Field{rho_lid_prev, rho_lid_out, nx, ny, static_cast<size_t>(nx) * ny,
                 x0 - k + R * part.rx, y0 - k + C * part.ry, rows.lo, rows.hi, cols.lo,
                 cols.hi};
  }
};

template <int R>
__global__ void __launch_bounds__(lbm::window::kThreads, 1)
tblock_step_kernel(const float* __restrict__ f, float* __restrict__ f_out,
                   const FieldTiles<R> tiles, const Params p, const int k) {
  lbm::window::window_run<R>(tiles, f, f_out, p, k);
}

template <int R>
int run(const void* f, const void* rho_lid_prev, void* f_out, void* rho_lid_out,
        const Params& p, const int k, const int cx, const int cy, cudaStream_t stream) {
  constexpr int C = lbm::window::kCells / R;
  const int own_x = R * cx - 2 * k, own_y = C * cy - 2 * k;
  const int ux = (p.nx + own_x - 1) / own_x, uy = (p.ny + own_y - 1) / own_y;
  const FieldTiles<R> tiles{static_cast<const float*>(rho_lid_prev),
                            static_cast<float*>(rho_lid_out), p.nx, p.ny, k, own_x, own_y,
                            uy, ux * uy};
  return lbm::window::launch<R>(tblock_step_kernel<R>, cx, cy, ux * uy, stream,
                                static_cast<const float*>(f), static_cast<float*>(f_out),
                                tiles, p, k);
}

}  // namespace

// K = k_steps fused steps (f, rho_lid_prev) -> (f_out, rho_lid_out) in one
// launch on `stream`, as clusters of cluster_x x cluster_y blocks of
// `rows` part rows each.  Pointers are device pointers to contiguous
// float32 buffers; the output must not alias the input.  Requires a shape
// that window::shape_ok takes (the wrapper checks).  Returns
// cudaGetLastError() after the launch.
extern "C" int lbm_tblock_step(const void* f, const void* rho_lid_prev,
                               void* f_out, void* rho_lid_out, int nx, int ny,
                               float u_lid, float lid_mom, float omega,
                               float tau0, float tau0_sq, float omega_minus,
                               float omega_e, float omega_eps, float omega_q,
                               int collision, int les, float smag_coef,
                               int k_steps, int rows, int cluster_x, int cluster_y,
                               void* stream) {
  const Params p{nx, ny, u_lid, lid_mom, omega, tau0, tau0_sq, omega_minus,
                 omega_e, omega_eps, omega_q, collision, les, smag_coef};
  if (!lbm::window::shape_ok(rows, cluster_x, cluster_y, k_steps) || nx < 1 || ny < 1 ||
      les == lbm::LES_PLANE) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 64: return run<64>(f, rho_lid_prev, f_out, rho_lid_out, p, k_steps,
                            cluster_x, cluster_y, s);
    case 32: return run<32>(f, rho_lid_prev, f_out, rho_lid_out, p, k_steps,
                            cluster_x, cluster_y, s);
    default: return run<16>(f, rho_lid_prev, f_out, rho_lid_out, p, k_steps,
                           cluster_x, cluster_y, s);
  }
}

// How many clusters of cluster_x x cluster_y blocks of `rows` part rows the
// card holds at once, into *out (both temporal-block kernels take the same
// resources).  Returns a cudaError_t as an int.
extern "C" int lbm_tblock_max_clusters(int rows, int cluster_x, int cluster_y, int* out) {
  if (!lbm::window::shape_ok(rows, cluster_x, cluster_y, 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (rows) {
    case 64: return lbm::window::max_clusters<64>(tblock_step_kernel<64>, cluster_x,
                                                  cluster_y, out);
    case 32: return lbm::window::max_clusters<32>(tblock_step_kernel<32>, cluster_x,
                                                  cluster_y, out);
    default: return lbm::window::max_clusters<16>(tblock_step_kernel<16>, cluster_x,
                                                  cluster_y, out);
  }
}
