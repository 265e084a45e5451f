// The check of lbm_cell.cuh's div_exact on the card (built with the other
// sources by kernels/_build.py; called by chip_smoke.py and, in the serial
// CPU emulation, by tests/test_torch_csrc_emulated.py).  It is not on any
// simulation path: it counts the inputs x for which div_exact<b>(x) and the
// IEEE division x / b give different bits (NaN against NaN counts as
// equal), over all 2^32 bit patterns in one launch, or over a given list.

#include <cuda_runtime.h>

#include "lbm_cell.cuh"

namespace {

constexpr int kThreads = 256;

template <int kB>
__device__ __forceinline__ bool differs(const unsigned bits) {
  const float x = __uint_as_float(bits);
  const float want = x / static_cast<float>(kB);
  const float got = lbm::div_exact<kB>(x);
  return __float_as_uint(got) != __float_as_uint(want) && !(got != got && want != want);
}

template <int kB>
__global__ void __launch_bounds__(kThreads)
exact_div_check_kernel(const unsigned* __restrict__ patterns, const long long count,
                       unsigned long long* __restrict__ mismatches) {
  unsigned long long bad = 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < count; i += stride) {
    bad += differs<kB>(patterns ? patterns[i] : static_cast<unsigned>(i));
  }
  if (bad) atomicAdd(mismatches, bad);
}

template <int kB>
int run(const unsigned* patterns, const long long count, unsigned long long* mismatches,
        cudaStream_t stream) {
  const long long blocks = (count + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < 132 * 64 ? (blocks > 0 ? blocks : 1) : 132 * 64);
  exact_div_check_kernel<kB><<<grid, kThreads, 0, stream>>>(patterns, count, mismatches);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Adds to *mismatches (a device counter) the number of inputs for which
// div_exact<divisor> differs from x / divisor: the inputs are the bit
// patterns 0 .. count - 1 when patterns is null (count = 2^32: every
// float), else patterns[0 .. count).  divisor is 6, 9, 12 or 36.  Returns
// cudaGetLastError() after the launch.
extern "C" int lbm_exact_div_check(int divisor, const void* patterns, long long count,
                                   void* mismatches, void* stream) {
  const auto* pat = static_cast<const unsigned*>(patterns);
  auto* out = static_cast<unsigned long long*>(mismatches);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (divisor) {
    case 6: return run<6>(pat, count, out, s);
    case 9: return run<9>(pat, count, out, s);
    case 12: return run<12>(pat, count, out, s);
    case 36: return run<36>(pat, count, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
