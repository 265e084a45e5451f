// Fused pull collide-and-stream step of the D2Q9 lid-driven cavity, float32,
// for Hopper (built for sm_90a by kernels/_build.py with nvcc, bound through
// ctypes by kernels/pull.py).
//
// Replaces the TPU kernel of the JAX package:
//   kernels/pallas_pull.py::_make_kernel (:189), built by make_step (:394),
//   launched by the pl.pallas_call at :470.
// It computes exactly engine.make_fused_step for boundary="nebb": wrap gather
// -> reduced NEBB (left, right, bottom, lid) -> macros with the wall
// overrides and the lid closure -> feq -> SRT / TRT / MRT, with Smagorinsky
// on a scalar Cs^2 or on a staged Van Driest Cs^2 plane.
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
// (a thread would read a neighbour's already-updated populations).

#include <cuda_runtime.h>

namespace {

enum Collision { SRT = 0, TRT = 1, MRT = 2 };
enum Les { LES_NONE = 0, LES_SCALAR = 1, LES_PLANE = 2 };

struct Params {
  int nx, ny;
  float u_lid;
  float lid_mom;      // u_lid / 6, rounded once from double on the host
  float omega;        // shear relaxation rate (runtime: one build serves every Re)
  float tau0;         // 1 / omega
  float tau0_sq;      // tau0 * tau0, rounded once from double on the host
  float omega_minus;  // TRT omega^- from the BASE tau, also under LES
  float omega_e, omega_eps, omega_q;
  int collision;      // Collision
  int les;            // Les
  float smag_coef;    // 18 * sqrt(2) * Cs^2 for LES_SCALAR
};

constexpr float W0 = 4.0f / 9.0f;
constexpr float WA = 1.0f / 9.0f;
constexpr float WD = 1.0f / 36.0f;
constexpr float SQRT2_18 = 25.455844122715710f;  // 18 * sqrt(2)

__device__ __forceinline__ float feq_term(float rho_w, float cu, float usqr15) {
  return rho_w * (1.0f + 3.0f * cu + 4.5f * cu * cu - usqr15);
}

// The step at one cell (x, y).
__device__ __forceinline__ void
pull_cell(const float* __restrict__ f, const float* __restrict__ rho_lid_prev,
          const float* __restrict__ cs2_plane, float* __restrict__ f_out,
          float* __restrict__ rho_lid_out, const Params& p, const int x,
          const int y) {
  const int nx = p.nx, ny = p.ny;
  const size_t plane = (size_t)nx * ny;

  // Pull gather g_k(x, y) = f_k(x - cx_k, y + cy_k), wrapping at the edges.
  const int xm = x == 0 ? nx - 1 : x - 1;
  const int xp = x == nx - 1 ? 0 : x + 1;
  const int ym = y == 0 ? ny - 1 : y - 1;
  const int yp = y == ny - 1 ? 0 : y + 1;
  const size_t r0 = (size_t)x * ny, rm = (size_t)xm * ny, rp = (size_t)xp * ny;
  float g0 = f[0 * plane + r0 + y];
  float g1 = f[1 * plane + rm + y];
  float g2 = f[2 * plane + r0 + yp];
  float g3 = f[3 * plane + rp + y];
  float g4 = f[4 * plane + r0 + ym];
  float g5 = f[5 * plane + rm + yp];
  float g6 = f[6 * plane + rp + yp];
  float g7 = f[7 * plane + rp + ym];
  float g8 = f[8 * plane + rm + ym];

  // Reduced NEBB, in the engine's order: left, right, bottom, lid.
  const bool side = (x == 0) || (x == nx - 1);
  if (x == 0) { g1 = g3; g5 = g7; g8 = g6; }
  if (x == nx - 1) { g3 = g1; g6 = g8; g7 = g5; }
  if (y == ny - 1) { g2 = g4; g5 = g7; g6 = g8; }
  if (y == 0) {
    const float mom = side ? 0.0f : rho_lid_prev[x] * p.lid_mom;
    g4 = g2;
    g7 = g5 - mom;
    g8 = g6 + mom;
  }

  // Macros, wall velocity overrides and the lid-row density closure.
  float rho = g0 + g1 + g2 + g3 + g4 + g5 + g6 + g7 + g8;
  float ux = (g1 - g3 + g5 - g6 - g7 + g8) / rho;
  float uy = (g2 - g4 + g5 + g6 - g7 - g8) / rho;
  if (side || y == ny - 1) { ux = 0.0f; uy = 0.0f; }
  if (y == 0 && !side) {
    ux = p.u_lid;
    uy = 0.0f;
    rho = g0 + g1 + g3 + 2.0f * (g2 + g5 + g6);
  }

  // Equilibrium.
  const float usqr15 = 1.5f * (ux * ux + uy * uy);
  const float rw_a = rho * WA, rw_d = rho * WD;
  const float e0 = rho * W0 * (1.0f - usqr15);
  const float e1 = feq_term(rw_a, ux, usqr15);
  const float e2 = feq_term(rw_a, uy, usqr15);
  const float e3 = feq_term(rw_a, -ux, usqr15);
  const float e4 = feq_term(rw_a, -uy, usqr15);
  const float e5 = feq_term(rw_d, ux + uy, usqr15);
  const float e6 = feq_term(rw_d, -ux + uy, usqr15);
  const float e7 = feq_term(rw_d, -ux - uy, usqr15);
  const float e8 = feq_term(rw_d, ux - uy, usqr15);

  // Smagorinsky effective relaxation rate.
  float omega = p.omega;
  if (p.les != LES_NONE) {
    const float coef =
        p.les == LES_PLANE ? SQRT2_18 * cs2_plane[r0 + y] : p.smag_coef;
    const float qxy = (g5 - e5) - (g6 - e6) + (g7 - e7) - (g8 - e8);
    const float disc = p.tau0_sq + (coef * fabsf(qxy)) / rho;
    omega = 1.0f / (0.5f * (p.tau0 + sqrtf(disc)));
  }

  float o0, o1, o2, o3, o4, o5, o6, o7, o8;
  if (p.collision == SRT) {
    o0 = g0 - omega * (g0 - e0);
    o1 = g1 - omega * (g1 - e1);
    o2 = g2 - omega * (g2 - e2);
    o3 = g3 - omega * (g3 - e3);
    o4 = g4 - omega * (g4 - e4);
    o5 = g5 - omega * (g5 - e5);
    o6 = g6 - omega * (g6 - e6);
    o7 = g7 - omega * (g7 - e7);
    o8 = g8 - omega * (g8 - e8);
  } else if (p.collision == TRT) {
    const float om = p.omega_minus;
    // Pair (k, kbar): symmetric and antisymmetric parts of f and feq.
#define TRT_PAIR(ga, gb, ea, eb, oa, ob)                                   \
    {                                                                      \
      const float fp = 0.5f * (ga + gb), fm = 0.5f * (ga - gb);            \
      const float ep = 0.5f * (ea + eb), em = 0.5f * (ea - eb);            \
      oa = ga - omega * (fp - ep) - om * (fm - em);                        \
      ob = gb - omega * (fp - ep) + om * (fm - em);                        \
    }
    o0 = g0 - omega * (g0 - e0);
    TRT_PAIR(g1, g3, e1, e3, o1, o3)
    TRT_PAIR(g2, g4, e2, e4, o2, o4)
    TRT_PAIR(g5, g7, e5, e7, o5, o7)
    TRT_PAIR(g6, g8, e6, e8, o6, o8)
#undef TRT_PAIR
  } else {
    // MRT in the Gram-Schmidt moment space.
    const float s_ax = g1 + g2 + g3 + g4;
    const float s_di = g5 + g6 + g7 + g8;
    const float m0 = g0 + s_ax + s_di;
    const float jx = g1 - g3 + g5 - g6 - g7 + g8;
    const float jy = g2 - g4 + g5 + g6 - g7 - g8;
    float me = -4.0f * g0 - s_ax + 2.0f * s_di;
    float meps = 4.0f * g0 - 2.0f * s_ax + s_di;
    float qx = -2.0f * (g1 - g3) + g5 - g6 - g7 + g8;
    float qy = -2.0f * (g2 - g4) + g5 + g6 - g7 - g8;
    float pxx = g1 - g2 + g3 - g4;
    float pxy = g5 - g6 + g7 - g8;
    const float jx2 = jx * jx, jy2 = jy * jy;
    me -= p.omega_e * (me - (-2.0f * m0 + 3.0f * (jx2 + jy2)));
    meps -= p.omega_eps * (meps - (m0 - 3.0f * (jx2 + jy2) + 9.0f * jx2 * jy2));
    qx -= p.omega_q * (qx - (-jx + 3.0f * jx2 * jx));
    qy -= p.omega_q * (qy - (-jy + 3.0f * jy2 * jy));
    pxx -= omega * (pxx - (jx2 - jy2));
    pxy -= omega * (pxy - jx * jy);
    // f = M^-1 m with exact rational coefficients.
    const float r = m0 / 9.0f;
    const float e36 = me / 36.0f, eps36 = meps / 36.0f;
    const float ax_e = -e36 - 2.0f * eps36;
    const float di_e = 2.0f * e36 + eps36;
    const float jx6 = jx / 6.0f, jy6 = jy / 6.0f;
    const float qx6 = qx / 6.0f, qy6 = qy / 6.0f;
    const float pxx4 = pxx / 4.0f, pxy4 = pxy / 4.0f;
    o0 = r - 4.0f * e36 + 4.0f * eps36;
    o1 = r + ax_e + (jx6 - qx6) + pxx4;
    o2 = r + ax_e + (jy6 - qy6) - pxx4;
    o3 = r + ax_e + (-jx6 + qx6) + pxx4;
    o4 = r + ax_e + (-jy6 + qy6) - pxx4;
    o5 = r + di_e + (jx + jy) / 6.0f + (qx + qy) / 12.0f + pxy4;
    o6 = r + di_e + (-jx + jy) / 6.0f + (-qx + qy) / 12.0f - pxy4;
    o7 = r + di_e + (-jx - jy) / 6.0f + (-qx - qy) / 12.0f + pxy4;
    o8 = r + di_e + (jx - jy) / 6.0f + (qx - qy) / 12.0f - pxy4;
  }

  const size_t c = r0 + y;
  f_out[0 * plane + c] = o0;
  f_out[1 * plane + c] = o1;
  f_out[2 * plane + c] = o2;
  f_out[3 * plane + c] = o3;
  f_out[4 * plane + c] = o4;
  f_out[5 * plane + c] = o5;
  f_out[6 * plane + c] = o6;
  f_out[7 * plane + c] = o7;
  f_out[8 * plane + c] = o8;
  if (y == 0) rho_lid_out[x] = rho;
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
    pull_cell(f, rho_lid_prev, cs2_plane, f_out, rho_lid_out, p, x, y);
  }
}

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

extern "C" const char* lbm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
