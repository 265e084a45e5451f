// Fused push collide-and-stream step of the D2Q9 lid-driven cavity, float32,
// for Hopper (built for sm_90a by kernels/_build.py with nvcc, bound through
// ctypes by kernels/push.py).
//
// Replaces the TPU kernel of the JAX package:
//   kernels/pallas_push.py::_make_kernel (:65), built by make_push_step
//   (:171), launched by the pl.pallas_call at :201.
// It computes exactly engine.make_push_oracle_step for boundary="nebb" (no
// Van Driest plane), on the plain pre-collision field f: moments with the
// wall overrides ("wall" lid corners) -> feq -> collision -> push stream ->
// the full four-term NEBB with this step's feq, in the order left, right,
// bottom, lid.
//
// Bound: memory, as for the pull step: 72 B of device traffic per cell per
// step (one read and one write of the 9 planes) against about 170
// floating-point operations per cell.
//
// Design.  A scatter store cannot give the full NEBB in one launch: the
// rewrite at a wall cell needs the same step's streamed values of other
// cells.  So each block owns a 16 x 32 tile (x by y) and collides the tile
// plus a one-cell halo, 18 x 34 cells (1.20 times the tile's operations),
// into shared memory; after one __syncthreads() each own cell gathers its
// streamed populations st_k(x, y) = fpost_k(x - cx_k, y + cy_k) from there.
// The halo is loaded by wrapped global index, as torch.roll wraps in the
// plain version.  A wall cell recomputes its own feq from its pre-collision
// populations (the same function on the same inputs) and applies the NEBB.
// Input and output are two buffers: neighbouring blocks read the halo of
// the input while this one writes.

#include <cuda_runtime.h>

#include "lbm_cell.cuh"

namespace {

using lbm::Params;

constexpr int kTileX = 16, kTileY = 32;            // own cells per block
constexpr int kWinX = kTileX + 2, kWinY = kTileY + 2;
constexpr int kWinCells = kWinX * kWinY;
constexpr int kThreads = kTileX * kTileY;

__device__ __forceinline__ int wrap(const int v, const int n) {
  const int r = v % n;
  return r < 0 ? r + n : r;
}

// Moments with the wall overrides and the equilibrium of the pre-collision
// populations g at a cell with the given walls.
__device__ __forceinline__ float cell_feq(const float g[9], const bool side,
                                          const bool bottom, const bool lid,
                                          const Params& p, float e[9]) {
  float rho, ux, uy;
  lbm::cell_macros(g, side, bottom, lid, p.u_lid, rho, ux, uy);
  lbm::cell_equilibrium(rho, ux, uy, e);
  return rho;
}

// Own cell (x, y), at (ti, tj) in its tile: gather the streamed populations
// from the collided window, apply the four-term NEBB at the walls with the
// cell's own feq, and store.
__device__ __forceinline__ void stream_cell(
    const float* __restrict__ f, float* __restrict__ f_out,
    const float (*post)[kWinCells], const Params& p, const int ti,
    const int tj, const int x, const int y) {
  const int nx = p.nx, ny = p.ny;
  const size_t plane = (size_t)nx * ny;
  float st[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    st[k] = post[k][(ti + 1 - lbm::dx(k)) * kWinY + (tj + 1 - lbm::dy(k))];
  }
  const bool left = x == 0, right = x == nx - 1;
  const bool bottom = y == ny - 1, lid = y == 0;
  const size_t dst = (size_t)x * ny + y;
  if (left || right || bottom || lid) {
    float g[9], e[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) g[k] = f[k * plane + dst];
    cell_feq(g, left || right, bottom, lid, p, e);
    if (left) {    // incoming +x populations (1, 5, 8)
      st[1] = e[1] - e[3] + st[3];
      st[5] = e[5] - e[7] + st[7];
      st[8] = e[8] - e[6] + st[6];
    }
    if (right) {   // incoming -x populations (3, 6, 7)
      st[3] = e[3] - e[1] + st[1];
      st[6] = e[6] - e[8] + st[8];
      st[7] = e[7] - e[5] + st[5];
    }
    if (bottom) {  // incoming +y populations (2, 5, 6)
      st[2] = e[2] - e[4] + st[4];
      st[5] = e[5] - e[7] + st[7];
      st[6] = e[6] - e[8] + st[8];
    }
    if (lid) {     // incoming -y populations (4, 7, 8)
      st[4] = e[4] - e[2] + st[2];
      st[7] = e[7] - e[5] + st[5];
      st[8] = e[8] - e[6] + st[6];
    }
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) f_out[k * plane + dst] = st[k];
}

__global__ void __launch_bounds__(kThreads)
push_step_kernel(const float* __restrict__ f, float* __restrict__ f_out,
                 const Params p) {
  __shared__ float post[9][kWinCells];  // post-collision tile + halo
  const int nx = p.nx, ny = p.ny;
  const size_t plane = (size_t)nx * ny;
  const int wx = blockIdx.x * kTileX - 1, wy = blockIdx.y * kTileY - 1;

  // Collide the tile and its halo.
  for (int c = threadIdx.x; c < kWinCells; c += kThreads) {
    const int gx = wrap(wx + c / kWinY, nx), gy = wrap(wy + c % kWinY, ny);
    const size_t src = (size_t)gx * ny + gy;
    float g[9], e[9], o[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) g[k] = f[k * plane + src];
    const float rho = cell_feq(g, gx == 0 || gx == nx - 1, gy == ny - 1,
                               gy == 0, p, e);
    lbm::cell_collide(g, e, rho, nullptr, p, o);
#pragma unroll
    for (int k = 0; k < 9; ++k) post[k][c] = o[k];
  }
  __syncthreads();

  // Stream into the own cells and apply the walls.
  for (int t = threadIdx.x; t < kTileX * kTileY; t += kThreads) {
    const int ti = t / kTileY, tj = t % kTileY;
    const int x = wx + 1 + ti, y = wy + 1 + tj;
    if (x < nx && y < ny) stream_cell(f, f_out, post, p, ti, tj, x, y);
  }
}

}  // namespace

// One push step f -> f_out on `stream`.  Pointers are device pointers to
// contiguous float32 buffers that do not alias; Van Driest (les ==
// LES_PLANE) is not supported.  Returns cudaGetLastError() after the launch.
extern "C" int lbm_push_step(const void* f, void* f_out, int nx, int ny,
                             float u_lid, float lid_mom, float omega,
                             float tau0, float tau0_sq, float omega_minus,
                             float omega_e, float omega_eps, float omega_q,
                             int collision, int les, float smag_coef,
                             void* stream) {
  const Params p{nx, ny, u_lid, lid_mom, omega, tau0, tau0_sq, omega_minus,
                 omega_e, omega_eps, omega_q, collision, les, smag_coef};
  if (nx < 1 || ny < 1 || les == lbm::LES_PLANE) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((nx + kTileX - 1) / kTileX, (ny + kTileY - 1) / kTileY);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  push_step_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<float*>(f_out), p);
  return static_cast<int>(cudaGetLastError());
}
