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
// Bound: as tblock_step.cu.  A launch reads the shard's 9 planes (and the
// halo ring) once and writes them once for K steps, 72/K B of device
// traffic per cell per step, against about 170 floating-point operations
// per cell per step; on the card the single-device form is bound by
// instruction issue, and the halo it recomputes costs (64 / (64 - 2K))^2 of
// the operations.  The exchange between launches (tensor copies made by the
// wrapper) moves K-deep strips once per K steps instead of one-cell strips
// every step.
//
// Design: tblock_step.cu's window, loaded from the shard's carry instead of
// by global wrapped addressing.
// * The carry is (9, lx + 2K, ly + 2K), y contiguous, the shard's cells at
//   [K, K + lx) x [K, K + ly), the ring filled by the exchange (y strips
//   first, then x strips with the corners).  Each block owns a tile of
//   (64 - 2K)^2 of the shard's cells and stages the 64 x 64 window of the
//   carry around it, with a K-wide halo on all four sides, in dynamic shared
//   memory.  Window cells past the carry's edge (the last tiles of a shard
//   that is no multiple of the tile, or a shard narrower than the window)
//   read the nearest carry cell: they lie more than K cells from every own
//   cell, so what they compute never reaches one.
// * Every window cell is keyed to its global content cell
//   ((x0 + i - K) mod nx, (y0 + j - K) mod ny), x0, y0 the tile's first own
//   cell in global coordinates: its wall masks and its lid momentum come
//   from that cell.  The halo ring holds the periodic images of the
//   neighbours (the wrap of the edge shards), so the window is an exact
//   image of the domain around the tile, and the own cells are exact after
//   K steps whatever the walls do.  (The y wrap is visible in the trajectory
//   at the lid corners, so the wrapped rows must evolve as the rows they
//   mirror; the JAX kernel keys x to a global offset and y to the content
//   rows of its halo lanes, which this one rule covers.)
// * The lid density is carried per window cell, in a tenth shared plane
//   that does not stream: a lid cell reads and writes only its own slot, so
//   two images of the lid row in one window (a one-shard y axis on a short
//   field) never race.  It starts from the shard's lid-density panel
//   (lx + 2K,), whose x halo rides the same exchange; only the cells of the
//   global lid row that the shard owns write their densities back.
// * The planes are shifted cyclically over the flat window after each step,
//   as in tblock_step.cu, so a step is one in-place pass with one barrier;
//   windows that hold no wall cell run without masks.

#include <cuda_runtime.h>

#include "lbm_cell.cuh"

namespace {

using lbm::Params;

constexpr int kWin = 64;                   // window edge in cells, x and y
constexpr int kWinCells = kWin * kWin;     // a power of two
constexpr int kThreads = 1024;
constexpr size_t kSmemBytes = 10 * kWinCells * sizeof(float);

constexpr unsigned char kLeft = 1, kRight = 2;   // column keys
constexpr unsigned char kBottom = 1, kLid = 2;   // row keys

// The shard within the global grid.
struct Shard {
  int lx, ly;          // the shard's cells
  int x_off, y_off;    // global coordinates of its first cell
};

__device__ __forceinline__ int mod(const int v, const int n) {
  const int r = v % n;
  return r < 0 ? r + n : r;
}

// Shared-memory offset of plane k's window cell c after s steps
// (tblock_step.cu).
__device__ __forceinline__ int slot(const int k, const int c, const int s) {
  return k * kWinCells + ((c - s * (lbm::dx(k) * kWin + lbm::dy(k))) & (kWinCells - 1));
}

template <bool kWalls>
__device__ __forceinline__ void window_steps(float* __restrict__ win,
                                             float* __restrict__ rl,
                                             const unsigned char* cols,
                                             const unsigned char* rows,
                                             const Params& p,
                                             const int k_steps) {
  for (int s = 1; s <= k_steps; ++s) {
    for (int c = threadIdx.x; c < kWinCells; c += kThreads) {
      float g[9], o[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) g[k] = win[slot(k, c, s)];
      if (kWalls) {
        const unsigned char col = cols[c / kWin], row = rows[c % kWin];
        const bool left = col & kLeft, right = col & kRight, lid = row & kLid;
        const float rlp = (lid && !(left || right)) ? rl[c] : 0.0f;
        const float rho = lbm::fused_cell(g, left, right, row & kBottom, lid,
                                          rlp, nullptr, p, o);
        if (lid) rl[c] = rho;
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
tblock_sharded_step_kernel(const float* __restrict__ f,
                           const float* __restrict__ panel,
                           float* __restrict__ f_out,
                           float* __restrict__ panel_out, const Params p,
                           const Shard sh, const int k_steps) {
  extern __shared__ float win[];          // 9 planes of kWin x kWin
  float* const rl = win + 9 * kWinCells;  // lid density per window cell
  __shared__ unsigned char cols[kWin], rows[kWin];
  const int px = sh.lx + 2 * k_steps, py = sh.ly + 2 * k_steps;
  const size_t plane = (size_t)px * py;
  const int own = kWin - 2 * k_steps;
  // Window origin in carry coordinates (the tile's first own cell is
  // k_steps further in), and in global coordinates, unwrapped.
  const int cx0 = blockIdx.x * own, cy0 = blockIdx.y * own;
  const int gx0 = sh.x_off + cx0 - k_steps, gy0 = sh.y_off + cy0 - k_steps;

  for (int i = threadIdx.x; i < kWin; i += kThreads) {
    const int gx = mod(gx0 + i, p.nx), gy = mod(gy0 + i, p.ny);
    cols[i] = (gx == 0 ? kLeft : 0) | (gx == p.nx - 1 ? kRight : 0);
    rows[i] = (gy == p.ny - 1 ? kBottom : 0) | (gy == 0 ? kLid : 0);
  }
  // Stage the window (step 0 is stored unshifted) and the lid densities.
  for (int c = threadIdx.x; c < kWinCells; c += kThreads) {
    const int cx = min(cx0 + c / kWin, px - 1), cy = min(cy0 + c % kWin, py - 1);
    const size_t src = (size_t)cx * py + cy;
#pragma unroll
    for (int k = 0; k < 9; ++k) win[k * kWinCells + c] = f[k * plane + src];
    rl[c] = panel[cx];
  }
  __syncthreads();

  // Does the window hold a cell of any wall?  (Conservative for a window
  // wider than the field.)
  const bool walls = gx0 < 1 || gx0 + kWin > p.nx - 1 || gy0 < 1 ||
                     gy0 + kWin > p.ny - 1;
  if (walls) {
    window_steps<true>(win, rl, cols, rows, p, k_steps);
  } else {
    window_steps<false>(win, rl, cols, rows, p, k_steps);
  }

  // Write back the own cells that are the shard's (the last tile of a row
  // or column may reach past them).
  for (int c = threadIdx.x; c < kWinCells; c += kThreads) {
    const int i = c / kWin, j = c % kWin;
    const int cx = cx0 + i, cy = cy0 + j;
    if (i < k_steps || i >= k_steps + own || j < k_steps || j >= k_steps + own ||
        cx >= sh.lx + k_steps || cy >= sh.ly + k_steps) {
      continue;
    }
    const size_t dst = (size_t)cx * py + cy;
#pragma unroll
    for (int k = 0; k < 9; ++k) f_out[k * plane + dst] = win[slot(k, c, k_steps)];
    if (rows[j] & kLid) panel_out[cx] = rl[c];
  }
}

}  // namespace

// K = k_steps fused steps of one shard on `stream`: the carry f
// (9, lx + 2K, ly + 2K) with its halo ring filled and the lid-density panel
// (lx + 2K,) with its x halo filled -> the shard's cells of f_out (same
// shape) and, on a shard that owns the lid, the shard's cells of panel_out.
// (x_off, y_off) is the global coordinate of the shard's first cell; nx, ny
// and the scalars after them are kernels/pull.py::_scalars of the global
// grid.  Requires 1 <= k_steps, 2 * k_steps < 64, lx, ly >= k_steps, no Van
// Driest plane, and at most 65535 tiles along y (the wrapper checks).
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
  if (k_steps < 1 || 2 * k_steps >= kWin || lx < k_steps || ly < k_steps ||
      les == lbm::LES_PLANE) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int own = kWin - 2 * k_steps;
  const dim3 grid((lx + own - 1) / own, (ly + own - 1) / own);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  // Above 48 KB, dynamic shared memory must be asked for (per device).
  const cudaError_t attr = cudaFuncSetAttribute(
      tblock_sharded_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  tblock_sharded_step_kernel<<<grid, kThreads, kSmemBytes,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<const float*>(panel),
      static_cast<float*>(f_out), static_cast<float*>(panel_out), p, sh,
      k_steps);
  return static_cast<int>(cudaGetLastError());
}
