// Fused push collide-and-stream step of the D2Q9 lid-driven cavity, float32,
// for Hopper (built for sm_90a by kernels/_build.py with nvcc, bound through
// ctypes by kernels/push.py).
//
// Replaces the TPU kernel of the JAX package:
//   kernels/pallas_push.py::_make_kernel (:65), built by make_push_step
//   (:171), launched by the pl.pallas_call at :201.
// It computes exactly engine.make_push_oracle_step (no Van Driest plane), on
// the plain pre-collision field f: moments with the wall overrides -> feq ->
// collision -> push stream -> the walls, for three wall kinds (kWall):
//   WALL_NEBB        the full four-term NEBB with this step's feq, in the
//                    order left, right, bottom, lid ("wall" lid corners);
//                    the entry lbm_push_step, as the Pallas kernel;
//   WALL_WEST_EQ     boundary="nebb_west_eq": the two lid corners belong to
//                    the lid in the moments, the west wall takes this step's
//                    pure feq, then east, bottom and lid NEBB (MRT.py's
//                    order);
//   WALL_BOUNCE_BACK boundary="bounce_back": each wall population takes the
//                    same node's post-collision opposite (left, right,
//                    bottom over whole edges), the Bouzidi lid on the
//                    interior columns (f4 = p2, f7 = p5 - u_lid/6, f8 = p6 +
//                    u_lid/6) and the static closure of the two lid corners.
// The last two have no Pallas counterpart (the JAX package runs them on its
// push oracle); the entry lbm_push_step_wall takes the kind as an argument.
//
// Bound: memory, as for the pull step: 72 B of device traffic per cell per
// step (one read and one write of the 9 planes) against about 170
// floating-point operations per cell.  The walls are O(perimeter).
//
// Design.  A scatter store cannot give the full NEBB in one launch: the
// rewrite at a wall cell needs the same step's streamed values of other
// cells.  So each block owns a 16 x 32 tile (x by y) and collides the tile
// plus a one-cell halo, 18 x 34 cells (1.20 times the tile's operations),
// into shared memory; after one __syncthreads() each own cell gathers its
// streamed populations st_k(x, y) = fpost_k(x - cx_k, y + cy_k) from there.
// The halo is loaded by wrapped global index, as torch.roll wraps in the
// plain version (a population that no wall rule rewrites keeps the wrapped
// value).  An NEBB wall cell recomputes its own feq from its pre-collision
// populations (the same function on the same inputs); a bounce-back wall
// cell reads its own post-collision populations from the window.  Input and
// output are two buffers: neighbouring blocks read the halo of the input
// while this one writes.

#include <cuda_runtime.h>

#include "lbm_cell.cuh"

namespace {

using lbm::Params;

enum Wall { WALL_NEBB = 0, WALL_WEST_EQ = 1, WALL_BOUNCE_BACK = 2 };

constexpr int kTileX = 16, kTileY = 32;            // own cells per block
constexpr int kWinX = kTileX + 2, kWinY = kTileY + 2;
constexpr int kWinCells = kWinX * kWinY;
constexpr int kThreads = kTileX * kTileY;

__device__ __forceinline__ int wrap(const int v, const int n) {
  const int r = v % n;
  return r < 0 ? r + n : r;
}

// Moments with the wall overrides and the equilibrium of the pre-collision
// populations g at a cell with the given walls; the lid corners belong to
// the lid for nebb_west_eq only.
template <int kWall>
__device__ __forceinline__ float cell_feq(const float g[9], const bool side,
                                          const bool bottom, const bool lid,
                                          const Params& p, float e[9]) {
  float rho, ux, uy;
  lbm::cell_macros<kWall == WALL_WEST_EQ>(g, side, bottom, lid, p.u_lid, rho,
                                          ux, uy);
  lbm::cell_equilibrium(rho, ux, uy, e);
  return rho;
}

// The NEBB rewrite of the incoming populations k of a wall, each with its
// opposite kb: st_k = e_k - e_kb + st_kb.
__device__ __forceinline__ void nebb(float st[9], const float e[9], const int k1,
                                     const int k1b, const int k2, const int k2b,
                                     const int k3, const int k3b) {
  st[k1] = e[k1] - e[k1b] + st[k1b];
  st[k2] = e[k2] - e[k2b] + st[k2b];
  st[k3] = e[k3] - e[k3b] + st[k3b];
}

// Own cell (x, y), at (ti, tj) in its tile: gather the streamed populations
// from the collided window, apply the walls of kind kWall, and store.
template <int kWall>
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
  if constexpr (kWall == WALL_BOUNCE_BACK) {
    // the node's own post-collision populations
    const int c = (ti + 1) * kWinY + tj + 1;
    if (left) { st[1] = post[3][c]; st[5] = post[7][c]; st[8] = post[6][c]; }
    if (right) { st[3] = post[1][c]; st[6] = post[8][c]; st[7] = post[5][c]; }
    if (bottom) { st[2] = post[4][c]; st[5] = post[7][c]; st[6] = post[8][c]; }
    if (lid) {
      st[4] = post[2][c];
      if (!left && !right) {  // Bouzidi lid (lid_mom: u_lid / 6)
        st[7] = post[5][c] - p.lid_mom;
        st[8] = post[6][c] + p.lid_mom;
      }
      if (left) st[7] = post[5][c];   // static closure of the corners
      if (right) st[8] = post[6][c];
    }
  } else if (left || right || bottom || lid) {
    float g[9], e[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) g[k] = f[k * plane + dst];
    cell_feq<kWall>(g, left || right, bottom, lid, p, e);
    if (left) {    // incoming +x populations (1, 5, 8)
      if constexpr (kWall == WALL_WEST_EQ) {
        st[1] = e[1];
        st[5] = e[5];
        st[8] = e[8];
      } else {
        nebb(st, e, 1, 3, 5, 7, 8, 6);
      }
    }
    if (right) nebb(st, e, 3, 1, 6, 8, 7, 5);    // incoming -x (3, 6, 7)
    if (bottom) nebb(st, e, 2, 4, 5, 7, 6, 8);   // incoming +y (2, 5, 6)
    if (lid) nebb(st, e, 4, 2, 7, 5, 8, 6);      // incoming -y (4, 7, 8)
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) f_out[k * plane + dst] = st[k];
}

template <int kWall>
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
    const float rho = cell_feq<kWall>(g, gx == 0 || gx == nx - 1,
                                      gy == ny - 1, gy == 0, p, e);
    lbm::cell_collide(g, e, rho, nullptr, p, o);
#pragma unroll
    for (int k = 0; k < 9; ++k) post[k][c] = o[k];
  }
  __syncthreads();

  // Stream into the own cells and apply the walls.
  for (int t = threadIdx.x; t < kTileX * kTileY; t += kThreads) {
    const int ti = t / kTileY, tj = t % kTileY;
    const int x = wx + 1 + ti, y = wy + 1 + tj;
    if (x < nx && y < ny) stream_cell<kWall>(f, f_out, post, p, ti, tj, x, y);
  }
}

template <int kWall>
int launch(const void* f, void* f_out, const Params& p, void* stream) {
  if (p.nx < 1 || p.ny < 1 || p.les == lbm::LES_PLANE) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((p.nx + kTileX - 1) / kTileX, (p.ny + kTileY - 1) / kTileY);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  push_step_kernel<kWall><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<float*>(f_out), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One push step f -> f_out on `stream`, NEBB walls.  Pointers are device
// pointers to contiguous float32 buffers that do not alias; Van Driest (les
// == LES_PLANE) is not supported.  Returns cudaGetLastError() after the
// launch.
extern "C" int lbm_push_step(const void* f, void* f_out, int nx, int ny,
                             float u_lid, float lid_mom, float omega,
                             float tau0, float tau0_sq, float omega_minus,
                             float omega_e, float omega_eps, float omega_q,
                             int collision, int les, float smag_coef,
                             void* stream) {
  const Params p{nx, ny, u_lid, lid_mom, omega, tau0, tau0_sq, omega_minus,
                 omega_e, omega_eps, omega_q, collision, les, smag_coef};
  return launch<WALL_NEBB>(f, f_out, p, stream);
}

// The same step with the walls of kind `wall` (Wall: 1 nebb_west_eq, 2
// bounce_back); another value is refused.
extern "C" int lbm_push_step_wall(const void* f, void* f_out, int nx, int ny,
                                  float u_lid, float lid_mom, float omega,
                                  float tau0, float tau0_sq, float omega_minus,
                                  float omega_e, float omega_eps, float omega_q,
                                  int collision, int les, float smag_coef,
                                  int wall, void* stream) {
  const Params p{nx, ny, u_lid, lid_mom, omega, tau0, tau0_sq, omega_minus,
                 omega_e, omega_eps, omega_q, collision, les, smag_coef};
  switch (wall) {
    case WALL_WEST_EQ: return launch<WALL_WEST_EQ>(f, f_out, p, stream);
    case WALL_BOUNCE_BACK: return launch<WALL_BOUNCE_BACK>(f, f_out, p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
