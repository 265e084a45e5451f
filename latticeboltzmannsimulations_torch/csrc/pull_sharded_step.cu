// Fused pull step of one shard of the D2Q9 lid-driven cavity, float32, for
// Hopper (built for sm_90a by kernels/_build.py with nvcc, bound through
// ctypes by kernels/pull_sharded.py).
//
// Replaces the TPU kernel of the JAX package:
//   kernels/pallas_pull_sharded.py::_make_local_kernel (:84), built by
//   _make_local_step (:204), launched by the pl.pallas_call at :228 inside
//   make_sharded_pallas_runner (:282).
// It computes exactly parallel/halo.py::local_step: one fused step of one
// shard's block, whose neighbours arrive in a one-cell halo ring, with the
// reduced NEBB walls applied only where this shard owns a global wall.
//
// Bound: memory, as pull_step.cu: 72 B of device traffic per cell per step
// against about 150 floating-point operations per cell.  The halo ring adds
// 2 * (lx + ly + 2) cells of reads per plane, and the exchange that fills
// it (tensor copies made by the wrapper between launches) moves the same
// strips once more.
//
// Design: the carry is (9, lx + 2, pitch), y contiguous, the shard's cells
// at x in [1, lx] and y in [y0, y0 + ly), the halo ring around them.  The
// wrapper sets y0 = 32 and a pitch that is a multiple of 32, so the first
// cell of every row starts a 128-byte line and a warp's loads and stores of
// a row are one line each, as in pull_step.cu's field of 2^n rows: with the
// tight carry (y0 = 1, pitch = ly + 2) the kernel ran about 1.3x slower
// (chip_smoke.py times the tight carry, and one whose rows start on 32-byte
// sectors, beside this one: PERF.md).  One thread per cell, x on
// gridDim.x and the y-blocks on gridDim.y with a stride loop over y, as
// pull_step.cu.  The gather reads fixed offsets of the carry with no wrap
// arithmetic: the halo supplies the neighbours (including the wrap of a
// one-shard axis, which the lid corners see).  A cell is on a wall when the
// shard owns that wall and the cell is on the shard's edge; the arithmetic
// after the gather is lbm_cell.cuh's fused_cell, so a sharded run equals
// pull_step on the global grid bit for bit.  The output is a second carry
// (an in-place pull would race); its cells are written, its halo ring is
// left for the next exchange.  Only a shard that owns the lid writes its
// (lx,) lid densities.

#include <cuda_runtime.h>

#include "lbm_cell.cuh"

namespace {

using lbm::Params;

// Which global walls this shard owns, and where its cells sit in the carry.
struct Edges {
  int left, right, top, bottom;
  int pitch, y0;
};

__device__ __forceinline__ void
shard_cell(const float* __restrict__ f, const float* __restrict__ rho_lid_prev,
           const float* __restrict__ cs2_plane, float* __restrict__ f_out,
           float* __restrict__ rho_lid_out, const Params& p, const Edges e,
           const int x, const int y) {
  const int lx = p.nx, ly = p.ny;
  const int py = e.pitch;
  const size_t plane = (size_t)(lx + 2) * py;
  const size_t c = (size_t)(x + 1) * py + (y + e.y0);

  // Pull gather g_k(x, y) = f_k(x - dx_k, y - dy_k), all inside the carry.
  float g[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    g[k] = f[k * plane + c - lbm::dx(k) * py - lbm::dy(k)];
  }

  const bool left = e.left && x == 0, right = e.right && x == lx - 1;
  const bool lid = e.top && y == 0;
  const float rlp = (lid && !(left || right)) ? rho_lid_prev[x] : 0.0f;
  float o[9];
  const float rho = lbm::fused_cell(g, left, right, e.bottom && y == ly - 1,
                                    lid, rlp, cs2_plane + (size_t)x * ly + y,
                                    p, o);
#pragma unroll
  for (int k = 0; k < 9; ++k) f_out[k * plane + c] = o[k];
  if (lid) rho_lid_out[x] = rho;
}

constexpr int kThreads = 128;
constexpr int kMaxYBlocks = 65535;  // the limit of gridDim.y

__global__ void __launch_bounds__(kThreads)
pull_sharded_step_kernel(const float* __restrict__ f,
                         const float* __restrict__ rho_lid_prev,
                         const float* __restrict__ cs2_plane,
                         float* __restrict__ f_out,
                         float* __restrict__ rho_lid_out, const Params p,
                         const Edges e) {
  const int x = blockIdx.x;
  for (int y = blockIdx.y * blockDim.x + threadIdx.x; y < p.ny;
       y += gridDim.y * blockDim.x) {
    shard_cell(f, rho_lid_prev, cs2_plane, f_out, rho_lid_out, p, e, x, y);
  }
}

}  // namespace

// One step of one shard on `stream`: the carry f (9, lx + 2, pitch) with
// its halo ring filled and the shard's lid densities rho_lid_prev (lx,) ->
// the cells of f_out (same shape) and, on a shard that owns the lid
// (top != 0), rho_lid_out (lx,).  The cells sit at y in [y0, y0 + ly) of
// each carry row (y0 >= 1, pitch >= y0 + ly + 1).  cs2_plane is the
// shard's (lx, ly) Van Driest plane, null unless les == LES_PLANE.
// left/right/top/bottom say which global walls the shard owns.  The
// scalars after them are kernels/pull.py::_scalars without nx, ny.
// Returns cudaGetLastError() after the launch.
extern "C" int lbm_pull_sharded_step(
    const void* f, const void* rho_lid_prev, const void* cs2_plane, void* f_out,
    void* rho_lid_out, int lx, int ly, int pitch, int y0, int left, int right,
    int top, int bottom, float u_lid, float lid_mom, float omega, float tau0,
    float tau0_sq, float omega_minus, float omega_e, float omega_eps,
    float omega_q, int collision, int les, float smag_coef, void* stream) {
  const Params p{lx, ly, u_lid, lid_mom, omega, tau0, tau0_sq, omega_minus,
                 omega_e, omega_eps, omega_q, collision, les, smag_coef};
  const Edges e{left, right, top, bottom, pitch, y0};
  if (lx < 1 || ly < 1 || y0 < 1 || pitch < y0 + ly + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int y_blocks = (ly + kThreads - 1) / kThreads;
  const dim3 grid(lx, y_blocks < kMaxYBlocks ? y_blocks : kMaxYBlocks);
  pull_sharded_step_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<const float*>(rho_lid_prev),
      static_cast<const float*>(cs2_plane), static_cast<float*>(f_out),
      static_cast<float*>(rho_lid_out), p, e);
  return static_cast<int>(cudaGetLastError());
}
