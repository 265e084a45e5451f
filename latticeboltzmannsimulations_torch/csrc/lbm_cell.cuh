// Per-cell arithmetic of the D2Q9 cavity, float32, shared by the five step
// kernels of this package (pull_step.cu, push_step.cu, pull_sharded_step.cu
// and, through tblock_window.cuh, tblock_step.cu and tblock_sharded_step.cu),
// so that all five do the same float operations in the same order: the
// moments with the wall overrides and the lid closure, the equilibrium, the
// Smagorinsky relaxation rate and the SRT / TRT / MRT collision, and the
// wall rewrites of the fused pull step: reduced NEBB, or (pull_step.cu's
// tangential entry only) the Zou-He tangential lid.
//
// Every expression follows the plain engine's (engine.make_fused_step and
// ops/) operation for operation, and the library is built with -fmad=false
// (kernels/_build.py), so a kernel rounds as the plain engine does on the
// card and gives its bits (on the CPU too without LES:
// tests/test_torch_csrc_emulated.py).  A last bit is not harmless here: the
// exact quotient m0 / 9, a sum in another order and FMA contraction moved a
// 1.5 M-step Re=1000 run's L2 against Ghia by 0.13 points, off the JAX
// package's record (PERF.md, section 6).
//
// Populations are indexed as in lattice.py: k = 0 rest, 1 (+x), 2 (+y),
// 3 (-x), 4 (-y), 5 (+x+y), 6 (-x+y), 7 (-x-y), 8 (+x-y); y index 0 is the
// lid.  Arrays of 9 floats are indexed with constants only, so after
// inlining they live in registers.

#pragma once

#include <cuda_runtime.h>

namespace lbm {

enum Collision { SRT = 0, TRT = 1, MRT = 2 };
enum Les { LES_NONE = 0, LES_SCALAR = 1, LES_PLANE = 2 };
// The lid closure of fused_cell: the engine's _fused_gather_bc (reduced
// NEBB) or _fused_gather_bc_tangential (boundary="nebb_tangential").
enum Lid { LID_NEBB = 0, LID_TANGENTIAL = 1 };

// Scalars of a step, the same for every kernel (the wrappers fill them from
// one function, kernels/pull.py::_scalars).
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
  // LID_TANGENTIAL only, each rounded once from double on the host:
  float lid_half;        // 0.5 * u_lid
  float lid_two_thirds;  // (2/3) * u_lid
  float lid_sixth;       // (1/6) * u_lid
  float lid_twelfth;     // u_lid / 12
};

// x / b for the constant divisors of the MRT back-transform (b = 6, 9, 12,
// 36), as the plain engine computes it: x times the reciprocal rounded to
// float.  PyTorch divides a tensor by a scalar that way on the card (and
// ops/collision.py writes the product out, so the CPU agrees); the JAX
// package's runs on the TPU track this product, not the correctly rounded
// quotient, whose long runs drifted from them (PERF.md, section 6).
template <int kB>
__device__ __forceinline__ float div_const(const float x) {
  constexpr float rcp = 1.0f / static_cast<float>(kB);
  return x * rcp;
}

constexpr float W0 = 4.0f / 9.0f;
constexpr float WA = 1.0f / 9.0f;
constexpr float WD = 1.0f / 36.0f;
constexpr float SQRT2_18 = 25.455844122715710f;  // 18 * sqrt(2)

// Streaming offsets: the pull gather reads g_k(x, y) = f_k(x - dx(k), y - dy(k)).
// (Functions, not arrays: a namespace-scope array is not usable in device code.)
__host__ __device__ constexpr int dx(const int k) {
  return (k == 1 || k == 5 || k == 8) ? 1 : (k == 3 || k == 6 || k == 7) ? -1 : 0;
}
__host__ __device__ constexpr int dy(const int k) {
  return (k == 4 || k == 7 || k == 8) ? 1 : (k == 2 || k == 5 || k == 6) ? -1 : 0;
}

__device__ __forceinline__ float feq_term(float rho_w, float cu, float usqr15) {
  return rho_w * (1.0f + 3.0f * cu + 4.5f * cu * cu - usqr15);
}

// TRT update of the pair (a, b = opposite of a): symmetric and
// antisymmetric parts of f and feq relax at omega and omega^-.
__device__ __forceinline__ void trt_pair(const float g[9], const float e[9],
                                         const int a, const int b,
                                         const float omega, const float om,
                                         float o[9]) {
  const float fp = 0.5f * (g[a] + g[b]), fm = 0.5f * (g[a] - g[b]);
  const float ep = 0.5f * (e[a] + e[b]), em = 0.5f * (e[a] - e[b]);
  o[a] = g[a] - omega * (fp - ep) - om * (fm - em);
  o[b] = g[b] - omega * (fp - ep) + om * (fm - em);
}

// Moments of g with the wall overrides and the lid-row density closure.
// The two top corners belong to the side walls ("wall" lid corners, every
// kernel's rule), or with kLidCorners to the lid (the push engine's
// nebb_west_eq, after the reference NumPy engine).
template <bool kLidCorners = false>
__device__ __forceinline__ void cell_macros(const float g[9], const bool side,
                                            const bool bottom, const bool lid,
                                            const float u_lid, float& rho,
                                            float& ux, float& uy) {
  rho = g[0] + g[1] + g[2] + g[3] + g[4] + g[5] + g[6] + g[7] + g[8];
  ux = (g[1] - g[3] + g[5] - g[6] - g[7] + g[8]) / rho;
  uy = (g[2] - g[4] + g[5] + g[6] - g[7] - g[8]) / rho;
  if (side || bottom) { ux = 0.0f; uy = 0.0f; }
  if (lid && (kLidCorners || !side)) {
    ux = u_lid;
    uy = 0.0f;
    rho = g[0] + g[1] + g[3] + 2.0f * (g[2] + g[5] + g[6]);
  }
}

__device__ __forceinline__ void cell_equilibrium(const float rho, const float ux,
                                                 const float uy, float e[9]) {
  const float usqr15 = 1.5f * (ux * ux + uy * uy);
  const float rw_a = rho * WA, rw_d = rho * WD;
  e[0] = rho * W0 * (1.0f - usqr15);
  e[1] = feq_term(rw_a, ux, usqr15);
  e[2] = feq_term(rw_a, uy, usqr15);
  e[3] = feq_term(rw_a, -ux, usqr15);
  e[4] = feq_term(rw_a, -uy, usqr15);
  e[5] = feq_term(rw_d, ux + uy, usqr15);
  e[6] = feq_term(rw_d, -ux + uy, usqr15);
  e[7] = feq_term(rw_d, -ux - uy, usqr15);
  e[8] = feq_term(rw_d, ux - uy, usqr15);
}

// Collision of g towards e.  cs2_cell points at the cell's Van Driest Cs^2
// and is read only for LES_PLANE.
__device__ __forceinline__ void cell_collide(const float g[9], const float e[9],
                                             const float rho,
                                             const float* cs2_cell,
                                             const Params& p, float o[9]) {
  // Smagorinsky effective relaxation rate.
  float omega = p.omega;
  if (p.les != LES_NONE) {
    const float coef = p.les == LES_PLANE ? SQRT2_18 * *cs2_cell : p.smag_coef;
    const float qxy = (g[5] - e[5]) - (g[6] - e[6]) + (g[7] - e[7]) - (g[8] - e[8]);
    const float disc = p.tau0_sq + (coef * fabsf(qxy)) / rho;
    omega = 1.0f / (0.5f * (p.tau0 + sqrtf(disc)));
  }

  if (p.collision == SRT) {
#pragma unroll
    for (int k = 0; k < 9; ++k) o[k] = g[k] - omega * (g[k] - e[k]);
  } else if (p.collision == TRT) {
    o[0] = g[0] - omega * (g[0] - e[0]);
    trt_pair(g, e, 1, 3, omega, p.omega_minus, o);
    trt_pair(g, e, 2, 4, omega, p.omega_minus, o);
    trt_pair(g, e, 5, 7, omega, p.omega_minus, o);
    trt_pair(g, e, 6, 8, omega, p.omega_minus, o);
  } else {
    // MRT in the Gram-Schmidt moment space.
    const float s_ax = g[1] + g[2] + g[3] + g[4];
    const float s_di = g[5] + g[6] + g[7] + g[8];
    // the density moment added one by one, as the plain engine's mrt_moments
    // does: (g0 + s_ax) + s_di rounds differently, and its r = m0 / 9 feeds
    // every population, so the difference biased the mass a run carries
    const float m0 = g[0] + g[1] + g[2] + g[3] + g[4] + g[5] + g[6] + g[7] + g[8];
    const float jx = g[1] - g[3] + g[5] - g[6] - g[7] + g[8];
    const float jy = g[2] - g[4] + g[5] + g[6] - g[7] - g[8];
    float me = -4.0f * g[0] - s_ax + 2.0f * s_di;
    float meps = 4.0f * g[0] - 2.0f * s_ax + s_di;
    float qx = -2.0f * (g[1] - g[3]) + g[5] - g[6] - g[7] + g[8];
    float qy = -2.0f * (g[2] - g[4]) + g[5] + g[6] - g[7] - g[8];
    float pxx = g[1] - g[2] + g[3] - g[4];
    float pxy = g[5] - g[6] + g[7] - g[8];
    const float jx2 = jx * jx, jy2 = jy * jy;
    me -= p.omega_e * (me - (-2.0f * m0 + 3.0f * (jx2 + jy2)));
    meps -= p.omega_eps * (meps - (m0 - 3.0f * (jx2 + jy2) + 9.0f * jx2 * jy2));
    qx -= p.omega_q * (qx - (-jx + 3.0f * jx2 * jx));
    qy -= p.omega_q * (qy - (-jy + 3.0f * jy2 * jy));
    pxx -= omega * (pxx - (jx2 - jy2));
    pxy -= omega * (pxy - jx * jy);
    // f = M^-1 m with exact rational coefficients.
    // (x / b is div_const: the plain engine's x * (1 / b).)
    const float r = div_const<9>(m0);
    const float e36 = div_const<36>(me), eps36 = div_const<36>(meps);
    const float ax_e = -e36 - 2.0f * eps36;
    const float di_e = 2.0f * e36 + eps36;
    const float jx6 = div_const<6>(jx), jy6 = div_const<6>(jy);
    const float qx6 = div_const<6>(qx), qy6 = div_const<6>(qy);
    const float pxx4 = pxx / 4.0f, pxy4 = pxy / 4.0f;
    o[0] = r - 4.0f * e36 + 4.0f * eps36;
    o[1] = r + ax_e + (jx6 - qx6) + pxx4;
    o[2] = r + ax_e + (jy6 - qy6) - pxx4;
    o[3] = r + ax_e + (-jx6 + qx6) + pxx4;
    o[4] = r + ax_e + (-jy6 + qy6) - pxx4;
    o[5] = r + di_e + div_const<6>(jx + jy) + div_const<12>(qx + qy) + pxy4;
    o[6] = r + di_e + div_const<6>(-jx + jy) + div_const<12>(-qx + qy) - pxy4;
    o[7] = r + di_e + div_const<6>(-jx - jy) + div_const<12>(-qx - qy) + pxy4;
    o[8] = r + di_e + div_const<6>(jx - jy) + div_const<12>(qx - qy) - pxy4;
  }
}

// The sum of the eight moving populations.
__device__ __forceinline__ float moving_sum(const float g[9]) {
  return g[1] + g[2] + g[3] + g[4] + g[5] + g[6] + g[7] + g[8];
}

// The Zou-He tangential lid closure at a lid-row cell, after the static
// walls, as the engine's _fused_gather_bc_tangential writes it: the row
// rule, then at the two lid corners the corner rule at unit density, the
// rest population closing the sum to 1.  Needs only the cell's gathered
// populations and u_lid: no previous lid density.
__device__ __forceinline__ void tangential_lid(float g[9], const bool left,
                                               const bool right,
                                               const Params& p) {
  const float tang = 0.5f * (g[1] - g[3]) - p.lid_half;
  g[4] = g[2];
  g[7] = g[5] + tang;
  g[8] = g[6] - tang;
  if (left) {
    g[1] = g[3] + p.lid_two_thirds;
    g[8] = g[6] + p.lid_sixth;
    g[5] = p.lid_twelfth;
    g[7] = -p.lid_twelfth;
    g[0] = 1.0f - moving_sum(g);
  }
  if (right) {
    g[3] = g[1] - p.lid_two_thirds;
    g[7] = g[5] - p.lid_sixth;
    g[6] = -p.lid_twelfth;
    g[8] = p.lid_twelfth;
    g[0] = 1.0f - moving_sum(g);
  }
}

// The fused pull step at one cell, after the gather: the walls in the
// engine's order (left, right, bottom, lid; the lid reduced NEBB or, for
// kLid = LID_TANGENTIAL, the tangential closure), moments, equilibrium,
// collision.  g holds the gathered populations and is rewritten by the
// walls; o receives the post-collision populations.  rho_lid_prev is the
// previous step's lid density of the cell's column, read only by the NEBB
// lid on the lid row between the side walls.  Returns the cell's density
// (on the lid row: the closure density the next step reads).
template <int kLid = LID_NEBB>
__device__ __forceinline__ float fused_cell(float g[9], const bool left,
                                            const bool right, const bool bottom,
                                            const bool lid,
                                            const float rho_lid_prev,
                                            const float* cs2_cell,
                                            const Params& p, float o[9]) {
  const bool side = left || right;
  if (left) { g[1] = g[3]; g[5] = g[7]; g[8] = g[6]; }
  if (right) { g[3] = g[1]; g[6] = g[8]; g[7] = g[5]; }
  if (bottom) { g[2] = g[4]; g[5] = g[7]; g[6] = g[8]; }
  if constexpr (kLid == LID_TANGENTIAL) {
    if (lid) tangential_lid(g, left, right, p);
  } else if (lid) {
    const float mom = side ? 0.0f : rho_lid_prev * p.lid_mom;
    g[4] = g[2];
    g[7] = g[5] - mom;
    g[8] = g[6] + mom;
  }
  float rho, ux, uy, e[9];
  cell_macros(g, side, bottom, lid, p.u_lid, rho, ux, uy);
  cell_equilibrium(rho, ux, uy, e);
  cell_collide(g, e, rho, cs2_cell, p, o);
  return rho;
}

}  // namespace lbm
