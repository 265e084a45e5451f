// The x-marching wavefront (tblock_march.cuh) as a single-device kernel:
// K fused pull steps per launch of the D2Q9 cavity, float32, the same
// function as the package's csrc/tblock_step.cu.  Built and measured by
// scripts/torch_tblock_designs.py only (it is not part of the package):
// window row r of the block that owns strip b and segment q is global row
// (q L - K + r) mod nx, window column j global column
// (b (W - 2K) - K + j) mod ny.

#include <cuda_runtime.h>

#include "tblock_march.cuh"

namespace {

using lbm::Params;
using lbm::march::wrap;

// Window addressing of one block on the whole field.
struct Field {
  const float* rho_lid_prev;
  float* rho_lid_out;
  int nx, ny;
  size_t plane;
  int rows;        // window rows: the segment's rows + 2K
  int gx0, gy0;    // global cell of window cell (0, 0), unwrapped
  int k, own;      // K, own columns of the strip

  __device__ int gx(const int r) const { return wrap(gx0 + r, nx); }
  __device__ int gy(const int j) const { return wrap(gy0 + j, ny); }
  __device__ size_t row_off(const int r) const { return static_cast<size_t>(gx(r)) * ny; }
  __device__ int col_off(const int j) const { return gy(j); }
  __device__ float lid_in(const int r) const { return rho_lid_prev[gx(r)]; }
  __device__ void lid_out(const int r, const float rho) const { rho_lid_out[gx(r)] = rho; }
  __device__ bool own_col(const int j) const {
    return j >= k && j < k + own && gy0 + j < ny;
  }
};

template <int W>
__global__ void __launch_bounds__(lbm::march::kThreads)
tblock_march_kernel(const float* __restrict__ f, const float* __restrict__ rho_lid_prev,
                    float* __restrict__ f_out, float* __restrict__ rho_lid_out,
                    const Params p, const int k, const int seg) {
  const int own = W - 2 * k;
  const int x0 = blockIdx.y * seg, y0 = blockIdx.x * own;   // first own cell
  const int len = min(seg, p.nx - x0);
  const Field a{rho_lid_prev, rho_lid_out, p.nx, p.ny, static_cast<size_t>(p.nx) * p.ny,
                len + 2 * k, x0 - k, y0 - k, k, own};
  lbm::march::march_block<W>(a, f, f_out, p, k);
}

template <int W>
int run(const void* f, const void* rho_lid_prev, void* f_out, void* rho_lid_out,
        const Params& p, const int k, const int seg_rows, cudaStream_t stream) {
  const int own = W - 2 * k;
  const int strips = (p.ny + own - 1) / own;
  return lbm::march::launch(tblock_march_kernel<W>, W, k, strips, p.nx, seg_rows, stream,
                            static_cast<const float*>(f),
                            static_cast<const float*>(rho_lid_prev),
                            static_cast<float*>(f_out), static_cast<float*>(rho_lid_out),
                            p, k);
}

}  // namespace

// As lbm_tblock_step, with the march's shape: width the strip's W (64 or
// 128; 2 * k_steps < width, and the rings must fit in shared memory) and
// seg_rows the segment length L, or 0 to choose it from the card's
// occupancy.
extern "C" int lbm_tblock_march_step(const void* f, const void* rho_lid_prev,
                                     void* f_out, void* rho_lid_out, int nx, int ny,
                                     float u_lid, float lid_mom, float omega,
                                     float tau0, float tau0_sq, float omega_minus,
                                     float omega_e, float omega_eps, float omega_q,
                                     int collision, int les, float smag_coef,
                                     int k_steps, int width, int seg_rows, void* stream) {
  const Params p{nx, ny, u_lid, lid_mom, omega, tau0, tau0_sq, omega_minus,
                 omega_e, omega_eps, omega_q, collision, les, smag_coef};
  if (!lbm::march::fits(width, k_steps) || nx < 1 || ny < 1 || seg_rows < 0 ||
      les == lbm::LES_PLANE) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return width == 64 ? run<64>(f, rho_lid_prev, f_out, rho_lid_out, p, k_steps, seg_rows, s)
                     : run<128>(f, rho_lid_prev, f_out, rho_lid_out, p, k_steps, seg_rows, s);
}
