// The x-ring halo exchange of the sharded temporal-block runner, float32,
// for Hopper: one launch copies every x strip that one device sends, each
// straight into the carry that receives it (built for sm_90a by
// kernels/_build.py with nvcc, bound through ctypes by kernels/halo_rdma.py).
//
// Replaces the TPU kernel of the JAX package:
//   kernels/halo_rdma.py::make_x_halo_exchange (:137), its pl.pallas_calls
//   at :157 (_make_local_kernel, :57: mx == 1, local DMAs) and :174
//   (_make_remote_kernel, :85: mx > 1, remote DMAs behind a neighbour
//   barrier semaphore).
// It computes what the x phase of parallel/halo.py's exchange computes:
// each shard's last K cell columns (the full ring height, y halo rows
// included, so the corners travel) into the west halo of its x successor,
// its first K into the east halo of its x predecessor, and the same pair
// for the (lx + 2K,) lid-density panel.  With mx == 1 a shard's ring wraps
// onto itself.
//
// Bound: memory.  It moves bytes and does no arithmetic: each strip is read
// once and written once, 2 * 4 B * 9 * K * (ly + 2K) per f strip.
//
// Design: the TPU kernel's DMA windows are the x strips because x is the
// sublane axis there; in the port's layout x is the outer axis and y the
// contiguous one, so an x strip of the tight carry (9, lx + 2K, ly + 2K) is,
// per plane, one contiguous run of K * (ly + 2K) floats.  The wrapper
// describes every strip in a device-side table, one row of six int64 per
// strip: source address, destination address, planes, source and
// destination plane strides (floats), floats per plane.  The destination
// may be a carry on this card, on a peer card of the same process (peer
// access enabled), or of another process mapped into this one through CUDA
// IPC; the wrapper orders the launch against the readers and writers of
// those carries (events within a process, host barriers across processes:
// the TPU kernel's barrier semaphore).  The grid is (blocks along the
// longest run, strips, planes); each block copies its share of one plane's
// run with a grid-stride loop, in float4 where the source and destination
// share their 16-byte phase (a scalar head and tail around it), in floats
// otherwise.  Sources are cells and destinations are halos, so no two
// strips of a launch overlap and their order is free.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kFields = 6;            // int64 per strip in the table
constexpr long long kMaxBlocksX = 1024;
constexpr int kMaxGridYZ = 65535;     // the limit of gridDim.y and gridDim.z

__device__ __forceinline__ void copy_run(const float* __restrict__ src,
                                         float* __restrict__ dst,
                                         const long long n, const long long t,
                                         const long long stride) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  if (((s ^ d) & 15u) != 0) {
    for (long long i = t; i < n; i += stride) dst[i] = src[i];
    return;
  }
  long long head = static_cast<long long>(((16u - (s & 15u)) & 15u) / 4u);
  if (head > n) head = n;
  const long long n4 = (n - head) / 4;
  for (long long i = t; i < head; i += stride) dst[i] = src[i];
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (long long i = t; i < n4; i += stride) d4[i] = s4[i];
  for (long long i = head + 4 * n4 + t; i < n; i += stride) dst[i] = src[i];
}

__global__ void __launch_bounds__(kThreads)
halo_x_exchange_kernel(const long long* __restrict__ table) {
  const long long* row = table + static_cast<size_t>(blockIdx.y) * kFields;
  const long long plane = blockIdx.z;
  if (plane >= row[2]) return;
  const float* src = reinterpret_cast<const float*>(row[0]) + plane * row[3];
  float* dst = reinterpret_cast<float*>(row[1]) + plane * row[4];
  copy_run(src, dst, row[5],
           static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x,
           static_cast<long long>(gridDim.x) * blockDim.x);
}

}  // namespace

// Copy n_strips strips on `stream`, as the device-side table (n_strips rows
// of six int64, see above) describes them; max_planes and max_count bound
// the table's planes and floats per plane.  Returns cudaGetLastError()
// after the launch.
extern "C" int lbm_halo_x_exchange(const void* table, int n_strips,
                                   int max_planes, long long max_count,
                                   void* stream) {
  if (n_strips < 1 || n_strips > kMaxGridYZ || max_planes < 1 ||
      max_planes > kMaxGridYZ || max_count < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long blocks_x = (max_count / 4 + kThreads - 1) / kThreads;
  if (blocks_x < 1) blocks_x = 1;
  if (blocks_x > kMaxBlocksX) blocks_x = kMaxBlocksX;
  const dim3 grid(static_cast<unsigned>(blocks_x), n_strips, max_planes);
  halo_x_exchange_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table));
  return static_cast<int>(cudaGetLastError());
}

// Let `device` read and write the memory of `peer` (a card of the same
// process), so that a strip can be written straight into a carry there.
// Already enabled counts as success.  Leaves the current device as it was.
extern "C" int lbm_enable_peer_access(int device, int peer) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // clear it: it is not an error here
      err = cudaSuccess;
    }
  }
  const cudaError_t back = cudaSetDevice(current);
  return static_cast<int>(err != cudaSuccess ? err : back);
}
