// Native CPU engine: fused pull collide-and-stream D2Q9 step, OpenMP.
//
// The host-side runtime engine (the role the reference fills with its
// Cython/OpenMP extension, reference: functions.pyx:45-222 compiled by
// setup.py:6-20): one fused gather + NEBB + macros + collide pass per cell,
// parallel over grid columns, N steps per call with double buffering.
// Semantics mirror engine.make_fused_step exactly (state = post-collision f
// + previous lid-row density; reduced NEBB wall algebra), so the tests can
// pin this engine to the plain engine and to the JAX package's copy of this
// source.
//
// Build: g++ -O3 -march=native -ffast-math -fopenmp -shared -fPIC, at first
// use (native/engine.py).  C ABI only — bound via ctypes, no pybind11.

#include <cmath>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// D2Q9 velocity set, same ordering as lattice.py (rest; axis; diagonal).
constexpr int CX[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
constexpr int CY[9] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
constexpr double W[9] = {4.0 / 9, 1.0 / 9, 1.0 / 9, 1.0 / 9, 1.0 / 9,
                         1.0 / 36, 1.0 / 36, 1.0 / 36, 1.0 / 36};
constexpr int OPP[9] = {0, 3, 4, 1, 2, 7, 8, 5, 6};

enum Collision { SRT = 0, TRT = 1, MRT = 2 };

struct Params {
  int nx, ny;
  float omega;        // shear relaxation rate
  float u_lid;
  int collision;      // Collision enum
  float trt_magic;    // TRT Lambda
  float mrt_omega_e, mrt_omega_eps, mrt_omega_q;
  int turbulence;     // 0 none, 1 smagorinsky
  float smag_cs2;
};

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Equilibrium for one population (same algebra as ops/equilibrium.py).
inline float feq_k(int k, float rho, float ux, float uy, float usqr15) {
  const float cu = (float)CX[k] * ux + (float)CY[k] * uy;
  return rho * (float)W[k] * (1.0f + 3.0f * cu + 4.5f * cu * cu - usqr15);
}

void collide_cell(const Params& p, const float g[9], float rho, float ux,
                  float uy, float out[9]) {
  const float usqr15 = 1.5f * (ux * ux + uy * uy);
  float feq[9];
  for (int k = 0; k < 9; ++k) feq[k] = feq_k(k, rho, ux, uy, usqr15);

  float omega = p.omega;
  float tau0 = 1.0f / omega;
  if (p.turbulence == 1) {
    // Smagorinsky effective tau from the off-diagonal non-equilibrium
    // momentum flux (ops/collision.py::smagorinsky_tau).
    const float qxy = (g[5] - feq[5]) - (g[6] - feq[6]) + (g[7] - feq[7]) -
                      (g[8] - feq[8]);
    const float disc =
        tau0 * tau0 + 18.0f * 1.41421356237309515f * p.smag_cs2 *
                          std::fabs(qxy) / rho;
    const float tau_eff = 0.5f * (tau0 + std::sqrt(disc));
    omega = 1.0f / tau_eff;
  }

  switch (p.collision) {
    case SRT: {
      for (int k = 0; k < 9; ++k) out[k] = g[k] - omega * (g[k] - feq[k]);
      break;
    }
    case TRT: {
      // omega^- derives from the *base* tau (the magic-parameter closure in
      // engine._collide uses tau0, not the LES-modified effective tau).
      const float omega_minus =
          1.0f / (0.5f + p.trt_magic / (tau0 - 0.5f));
      for (int k = 0; k < 9; ++k) {
        const int kb = OPP[k];
        const float fp = 0.5f * (g[k] + g[kb]), fm = 0.5f * (g[k] - g[kb]);
        const float ep = 0.5f * (feq[k] + feq[kb]),
                    em = 0.5f * (feq[k] - feq[kb]);
        out[k] = g[k] - omega * (fp - ep) - omega_minus * (fm - em);
      }
      break;
    }
    case MRT: {
      // Gram-Schmidt moment collision, unrolled (ops/collision.py).
      const float s_ax = g[1] + g[2] + g[3] + g[4];
      const float s_di = g[5] + g[6] + g[7] + g[8];
      const float m0 = g[0] + s_ax + s_di;
      const float jx = g[1] - g[3] + g[5] - g[6] - g[7] + g[8];
      const float jy = g[2] - g[4] + g[5] + g[6] - g[7] - g[8];
      float m[9] = {
          m0,
          -4.0f * g[0] - s_ax + 2.0f * s_di,
          4.0f * g[0] - 2.0f * s_ax + s_di,
          jx,
          -2.0f * (g[1] - g[3]) + g[5] - g[6] - g[7] + g[8],
          jy,
          -2.0f * (g[2] - g[4]) + g[5] + g[6] - g[7] - g[8],
          g[1] - g[2] + g[3] - g[4],
          g[5] - g[6] + g[7] - g[8],
      };
      const float jx2 = jx * jx, jy2 = jy * jy;
      const float meq[9] = {
          m0,
          -2.0f * m0 + 3.0f * (jx2 + jy2),
          m0 - 3.0f * (jx2 + jy2) + 9.0f * jx2 * jy2,
          jx,
          -jx + 3.0f * jx2 * jx,
          jy,
          -jy + 3.0f * jy2 * jy,
          jx2 - jy2,
          jx * jy,
      };
      const float ov[9] = {0.0f, p.mrt_omega_e, p.mrt_omega_eps, 0.0f,
                           p.mrt_omega_q, 0.0f, p.mrt_omega_q, omega, omega};
      for (int k = 0; k < 9; ++k) m[k] -= ov[k] * (m[k] - meq[k]);
      // f = M^-1 m with exact rational coefficients.
      const float r = m[0] / 9.0f;
      const float e36 = m[1] / 36.0f, eps36 = m[2] / 36.0f;
      const float ax_e = -e36 - 2.0f * eps36, di_e = 2.0f * e36 + eps36;
      const float jx6 = m[3] / 6.0f, qx6 = m[4] / 6.0f;
      const float jy6 = m[5] / 6.0f, qy6 = m[6] / 6.0f;
      const float qx12 = m[4] / 12.0f, qy12 = m[6] / 12.0f;
      const float pxx4 = m[7] / 4.0f, pxy4 = m[8] / 4.0f;
      out[0] = r - 4.0f * e36 + 4.0f * eps36;
      out[1] = r + ax_e + (jx6 - qx6) + pxx4;
      out[2] = r + ax_e + (jy6 - qy6) - pxx4;
      out[3] = r + ax_e + (-jx6 + qx6) + pxx4;
      out[4] = r + ax_e + (-jy6 + qy6) - pxx4;
      out[5] = r + di_e + (jx6 + jy6) + (qx12 + qy12) + pxy4;
      out[6] = r + di_e + (-jx6 + jy6) + (-qx12 + qy12) - pxy4;
      out[7] = r + di_e + (-jx6 - jy6) + (-qx12 - qy12) + pxy4;
      out[8] = r + di_e + (jx6 - jy6) + (qx12 - qy12) - pxy4;
      break;
    }
  }
}

void step_once(const Params& p, const float* f, const float* rho_lid_prev,
               float* f_out, float* rho_lid_out) {
  const int nx = p.nx, ny = p.ny;
  const long plane = (long)nx * ny;

#pragma omp parallel for schedule(static)
  for (int x = 0; x < nx; ++x) {
    for (int y = 0; y < ny; ++y) {
      // Pull gather g_k(x, y) = f_k(x - cx, y + cy); out-of-domain reads
      // WRAP, matching the engine's wrap-around gather exactly — at the
      // lid corners the wall rewrites chain (right wall copies g8 into g6
      // before the lid rewrites g8), so the wrap value is trajectory-visible
      // and all backends must agree on it.
      float g[9];
      for (int k = 0; k < 9; ++k) {
        const int sx = (x - CX[k] + nx) % nx;
        const int sy = (y + CY[k] + ny) % ny;
        g[k] = f[k * plane + (long)sx * ny + sy];
      }
      // Reduced NEBB (engine._fused_gather_bc order: left, right, bottom, lid).
      if (x == 0) { g[1] = g[3]; g[5] = g[7]; g[8] = g[6]; }
      if (x == nx - 1) { g[3] = g[1]; g[6] = g[8]; g[7] = g[5]; }
      if (y == ny - 1) { g[2] = g[4]; g[5] = g[7]; g[6] = g[8]; }
      if (y == 0) {
        const bool corner = (x == 0) || (x == nx - 1);
        const float mom =
            corner ? 0.0f : rho_lid_prev[x] * (p.u_lid / 6.0f);
        g[4] = g[2];
        g[7] = g[5] - mom;
        g[8] = g[6] + mom;
      }
      // Macros + wall overrides (engine._fused_macros).
      float rho = 0.0f;
      for (int k = 0; k < 9; ++k) rho += g[k];
      float ux = (g[1] - g[3] + g[5] - g[6] - g[7] + g[8]) / rho;
      float uy = (g[2] - g[4] + g[5] + g[6] - g[7] - g[8]) / rho;
      const bool is_side = (x == 0) || (x == nx - 1);
      if (is_side || y == ny - 1) { ux = 0.0f; uy = 0.0f; }
      if (y == 0 && !is_side) {
        ux = p.u_lid;
        uy = 0.0f;
        rho = g[0] + g[1] + g[3] + 2.0f * (g[2] + g[5] + g[6]);
      }
      float out[9];
      collide_cell(p, g, rho, ux, uy, out);
      for (int k = 0; k < 9; ++k) f_out[k * plane + (long)x * ny + y] = out[k];
      if (y == 0) rho_lid_out[x] = rho;
    }
  }
}

}  // namespace

extern "C" {

// Run n_steps fused steps.  f/rho_lid are read, f_out/rho_lid_out written;
// both pairs must be distinct buffers (double-buffered internally).
void lbm_run(const float* f, const float* rho_lid, float* f_out,
             float* rho_lid_out, int nx, int ny, int n_steps, float omega,
             float u_lid, int collision, float trt_magic, float mrt_omega_e,
             float mrt_omega_eps, float mrt_omega_q, int turbulence,
             float smag_cs2) {
  Params p{nx, ny, omega, u_lid, collision, trt_magic,
           mrt_omega_e, mrt_omega_eps, mrt_omega_q, turbulence, smag_cs2};
  const long n = 9L * nx * ny;
  if (n_steps == 0) {
    std::memcpy(f_out, f, n * sizeof(float));
    std::memcpy(rho_lid_out, rho_lid, nx * sizeof(float));
    return;
  }
  // Ping-pong between the caller's output buffers and one scratch pair,
  // phased so the final step writes the outputs; consecutive steps never
  // alias their source.
  std::vector<float> buf_f(n);
  std::vector<float> buf_l(nx);
  const float* src_f = f;
  const float* src_l = rho_lid;
  for (int it = 0; it < n_steps; ++it) {
    const bool to_out = (it % 2) == ((n_steps - 1) % 2);
    float* dst_f = to_out ? f_out : buf_f.data();
    float* dst_l = to_out ? rho_lid_out : buf_l.data();
    step_once(p, src_f, src_l, dst_f, dst_l);
    src_f = dst_f;
    src_l = dst_l;
  }
}

int lbm_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
