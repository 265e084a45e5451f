// Fused pull collide-and-stream step of the D2Q9 lid-driven cavity, float32,
// for Hopper (built for sm_90a by kernels/_build.py with nvcc, bound through
// ctypes by kernels/pull.py).
//
// Replaces the TPU kernel of the JAX package:
//   kernels/pallas_pull.py::_make_kernel (:189), built by make_step (:394),
//   launched by the pl.pallas_call at :470; and its sweep form (the same
//   pallas_call with a traced omega and n_cav cavities stacked along x,
//   make_scan_runner_omega :543, make_sweep_runner :560) as a second entry,
//   lbm_pull_sweep_step, over the same cell routine.
// A third entry, lbm_pull_step_tangential, takes the Zou-He tangential lid
// (boundary="nebb_tangential"), which the JAX driver runs on its XLA-fused
// engine.make_scan_runner (sim.py:107-113): a second instantiation of the
// one-step kernel, whose NEBB instantiation it leaves as it was.
// It computes engine.make_fused_step: wrap gather -> static walls (left,
// right, bottom) -> the lid (reduced NEBB, or the tangential closure) ->
// macros with the wall overrides and the lid closure -> feq -> SRT / TRT /
// MRT, with Smagorinsky on a scalar Cs^2 or on a staged Van Driest Cs^2
// plane.  The sweep entry is reduced NEBB only.
//
// Bound: memory.  A step reads the 9 f32 planes once and writes them once:
// 72 B of device traffic per cell per step (plus 8 B per lid column), against
// roughly 150 floating-point operations per cell, about 2 per byte, far
// below the card's ratio of peak operations to bytes.  So the least time of
// a step is 72 B * X * Y over the device-memory rate.
//
// Design: one thread per cell, y the contiguous axis (index k*X*Y + x*Y + y).
// x runs on gridDim.x (up to 2^31 - 1 columns) and the y-blocks on
// gridDim.y (at most 65535 of them), with a stride loop over y for taller
// fields, so no field that fits on the card is out of the grid's reach.
// (A one-dimensional grid that divides the block index by the number of
// y-blocks measured 3% slower at 1024^2: PERF.md.)  The nine loads of a
// warp are each coalesced: the x-shifted planes read a neighbouring row, the
// y-shifted planes the same row one element off, and the three rows a block
// touches are reused through L1/L2, so device memory sees about one read of
// each plane.  The gather wraps in x and y, as torch.roll does in the plain
// version: the wrap value is visible in the trajectory at the lid corners.
// Input and output are two buffers: a pull gather done in place would race
// (a thread would read a neighbour's already-updated populations).  The
// per-cell arithmetic after the gather lives in lbm_cell.cuh, shared with
// tblock_step.cu and push_step.cu.

#include <cuda_runtime.h>

#include "lbm_cell.cuh"

namespace {

using lbm::Params;

// The step at one cell (x, y) of a field `width` columns wide: the gather
// here, the rest in lbm_cell.cuh.  x is the field's column, xl the column
// within the cell's cavity (the same for one cavity; in the sweep form the
// cavities are stacked along x, each p.nx wide).  The gather wraps over the
// whole field; the walls are keyed to xl; the lid densities to x.  kLid
// picks the lid closure (lbm::Lid); the tangential one reads no
// rho_lid_prev.
template <int kLid>
__device__ __forceinline__ void
pull_cell(const float* __restrict__ f, const float* __restrict__ rho_lid_prev,
          const float* __restrict__ cs2_plane, float* __restrict__ f_out,
          float* __restrict__ rho_lid_out, const Params& p, const int width,
          const int x, const int xl, const int y) {
  const int ny = p.ny;
  const size_t plane = (size_t)width * ny;

  // Pull gather g_k(x, y) = f_k(x - cx_k, y + cy_k), wrapping at the edges.
  const int xm = x == 0 ? width - 1 : x - 1;
  const int xp = x == width - 1 ? 0 : x + 1;
  const int ym = y == 0 ? ny - 1 : y - 1;
  const int yp = y == ny - 1 ? 0 : y + 1;
  const size_t r0 = (size_t)x * ny, rm = (size_t)xm * ny, rp = (size_t)xp * ny;
  float g[9];
  g[0] = f[0 * plane + r0 + y];
  g[1] = f[1 * plane + rm + y];
  g[2] = f[2 * plane + r0 + yp];
  g[3] = f[3 * plane + rp + y];
  g[4] = f[4 * plane + r0 + ym];
  g[5] = f[5 * plane + rm + yp];
  g[6] = f[6 * plane + rp + yp];
  g[7] = f[7 * plane + rp + ym];
  g[8] = f[8 * plane + rm + ym];

  const bool left = xl == 0, right = xl == p.nx - 1;
  const bool lid = y == 0;
  float rlp = 0.0f;
  if constexpr (kLid == lbm::LID_NEBB) {
    if (lid && !(left || right)) rlp = rho_lid_prev[x];
  }
  const size_t c = r0 + y;
  float o[9];
  const float rho = lbm::fused_cell<kLid>(g, left, right, y == ny - 1, lid,
                                          rlp, cs2_plane + c, p, o);
#pragma unroll
  for (int k = 0; k < 9; ++k) f_out[k * plane + c] = o[k];
  if (lid) rho_lid_out[x] = rho;
}

constexpr int kThreads = 128;
constexpr int kMaxYBlocks = 65535;  // the limit of gridDim.y

__global__ void __launch_bounds__(kThreads)
pull_step_kernel(const float* __restrict__ f,
                 const float* __restrict__ rho_lid_prev,
                 const float* __restrict__ cs2_plane,
                 float* __restrict__ f_out,
                 float* __restrict__ rho_lid_out,
                 const Params p) {
  const int x = blockIdx.x;
  for (int y = blockIdx.y * blockDim.x + threadIdx.x; y < p.ny;
       y += gridDim.y * blockDim.x) {
    pull_cell<lbm::LID_NEBB>(f, rho_lid_prev, cs2_plane, f_out, rho_lid_out,
                             p, p.nx, x, x, y);
  }
}

// pull_step_kernel with the tangential lid (a kernel of its own name, so
// that pull_step_kernel's code and name stay those of the NEBB step).
__global__ void __launch_bounds__(kThreads)
pull_step_tangential_kernel(const float* __restrict__ f,
                            const float* __restrict__ cs2_plane,
                            float* __restrict__ f_out,
                            float* __restrict__ rho_lid_out,
                            const Params p) {
  const int x = blockIdx.x;
  for (int y = blockIdx.y * blockDim.x + threadIdx.x; y < p.ny;
       y += gridDim.y * blockDim.x) {
    pull_cell<lbm::LID_TANGENTIAL>(f, nullptr, cs2_plane, f_out, rho_lid_out,
                                   p, p.nx, x, x, y);
  }
}

// The sweep form: gridDim.z cavities, each p.nx x p.ny, stacked along x in
// one field (index k*W*Y + x*Y + y with W = gridDim.z * p.nx), cavity
// blockIdx.z at columns blockIdx.z * p.nx + blockIdx.x.  Each cavity takes
// its own (omega, tau0, tau0^2, omega^-) from `cav`, one float4 per cavity;
// the rest of p is shared.  Every population the gather takes across a
// cavity boundary (or the field's wrap) lands in a side wall's populations,
// which the NEBB rewrite overwrites by assignment before anything reads them,
// so the stack advances each cavity exactly as it would alone, and a NaN in
// one cavity reaches no other.
__global__ void __launch_bounds__(kThreads)
pull_sweep_kernel(const float* __restrict__ f,
                  const float* __restrict__ rho_lid_prev,
                  float* __restrict__ f_out,
                  float* __restrict__ rho_lid_out,
                  const Params p, const float4* __restrict__ cav) {
  Params q = p;
  const float4 c = cav[blockIdx.z];
  q.omega = c.x;
  q.tau0 = c.y;
  q.tau0_sq = c.z;
  q.omega_minus = c.w;
  const int width = gridDim.z * p.nx;
  const int xl = blockIdx.x;
  const int x = blockIdx.z * p.nx + xl;
  for (int y = blockIdx.y * blockDim.x + threadIdx.x; y < p.ny;
       y += gridDim.y * blockDim.x) {
    pull_cell<lbm::LID_NEBB>(f, rho_lid_prev, nullptr, f_out, rho_lid_out, q,
                             width, x, xl, y);
  }
}

constexpr int kMaxCavities = 65535;  // the limit of gridDim.z

}  // namespace

// One step (f, rho_lid_prev) -> (f_out, rho_lid_out) on `stream`.  Pointers
// are device pointers to contiguous float32 buffers; `cs2_plane` may be null
// unless les == LES_PLANE.  Returns cudaGetLastError() after the launch.
extern "C" int lbm_pull_step(const void* f, const void* rho_lid_prev,
                             const void* cs2_plane, void* f_out,
                             void* rho_lid_out, int nx, int ny, float u_lid,
                             float lid_mom, float omega, float tau0,
                             float tau0_sq, float omega_minus, float omega_e,
                             float omega_eps, float omega_q, int collision,
                             int les, float smag_coef, void* stream) {
  const Params p{nx, ny, u_lid, lid_mom, omega, tau0, tau0_sq, omega_minus,
                 omega_e, omega_eps, omega_q, collision, les, smag_coef};
  if (nx < 1 || ny < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int y_blocks = (ny + kThreads - 1) / kThreads;
  const dim3 grid(nx, y_blocks < kMaxYBlocks ? y_blocks : kMaxYBlocks);
  pull_step_kernel<<<grid, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<const float*>(rho_lid_prev),
      static_cast<const float*>(cs2_plane), static_cast<float*>(f_out),
      static_cast<float*>(rho_lid_out), p);
  return static_cast<int>(cudaGetLastError());
}

// One step with the tangential lid, (f) -> (f_out, rho_lid_out) on
// `stream`: lbm_pull_step's arguments without rho_lid_prev (the closure
// carries no lid density), and after smag_coef the lid's constants 0.5 u,
// (2/3) u, (1/6) u and u / 12.  rho_lid_out receives the lid row's density,
// as in lbm_pull_step.  Returns cudaGetLastError() after the launch.
extern "C" int lbm_pull_step_tangential(
    const void* f, const void* cs2_plane, void* f_out, void* rho_lid_out,
    int nx, int ny, float u_lid, float lid_mom, float omega, float tau0,
    float tau0_sq, float omega_minus, float omega_e, float omega_eps,
    float omega_q, int collision, int les, float smag_coef, float lid_half,
    float lid_two_thirds, float lid_sixth, float lid_twelfth, void* stream) {
  const Params p{nx, ny, u_lid, lid_mom, omega, tau0, tau0_sq, omega_minus,
                 omega_e, omega_eps, omega_q, collision, les, smag_coef,
                 lid_half, lid_two_thirds, lid_sixth, lid_twelfth};
  if (nx < 1 || ny < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int y_blocks = (ny + kThreads - 1) / kThreads;
  const dim3 grid(nx, y_blocks < kMaxYBlocks ? y_blocks : kMaxYBlocks);
  pull_step_tangential_kernel<<<grid, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<const float*>(cs2_plane),
      static_cast<float*>(f_out), static_cast<float*>(rho_lid_out), p);
  return static_cast<int>(cudaGetLastError());
}

// One step of n_cav stacked cavities (f, rho_lid_prev) -> (f_out,
// rho_lid_out) on `stream`: f is (9, n_cav * nx, ny), rho_lid (n_cav * nx),
// `cav` a device table of n_cav float4 rows (omega, tau0, tau0^2, omega^-),
// computed on the host by kernels/pull.py::cavity_table.  Takes no Van
// Driest plane (its Cs^2 depends on Re).  Returns cudaGetLastError() after
// the launch.
extern "C" int lbm_pull_sweep_step(const void* f, const void* rho_lid_prev,
                                   void* f_out, void* rho_lid_out, int n_cav,
                                   const void* cav, int nx, int ny, float u_lid,
                                   float lid_mom, float omega_e,
                                   float omega_eps, float omega_q,
                                   int collision, int les, float smag_coef,
                                   void* stream) {
  const Params p{nx, ny, u_lid, lid_mom, 0.0f, 0.0f, 0.0f, 0.0f,
                 omega_e, omega_eps, omega_q, collision, les, smag_coef};
  if (nx < 1 || ny < 1 || n_cav < 1 || n_cav > kMaxCavities ||
      (long long)n_cav * nx > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (les == lbm::LES_PLANE) return static_cast<int>(cudaErrorInvalidValue);
  const int y_blocks = (ny + kThreads - 1) / kThreads;
  const dim3 grid(nx, y_blocks < kMaxYBlocks ? y_blocks : kMaxYBlocks, n_cav);
  pull_sweep_kernel<<<grid, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<const float*>(rho_lid_prev),
      static_cast<float*>(f_out), static_cast<float*>(rho_lid_out), p,
      static_cast<const float4*>(cav));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lbm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
