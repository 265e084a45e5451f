// The halo refresh of a mesh's shards, float32, for Hopper: one launch per
// card copies every rectangle that the card's shards send (y strips, x
// strips, corners, the lid panels' x halos and their copies over each
// column), each straight into the carry that receives it (built for sm_90a
// by kernels/_build.py with nvcc, bound through ctypes by
// kernels/halo_rdma.py).
//
// Replaces the TPU kernel of the JAX package:
//   kernels/halo_rdma.py::make_x_halo_exchange (:137), its pl.pallas_calls
//   at :157 (_make_local_kernel, :57: mx == 1, local DMAs) and :174
//   (_make_remote_kernel, :85: mx > 1, remote DMAs behind a neighbour
//   barrier semaphore).
// That kernel moves the x strips; here the same launch takes a table of any
// rectangles, so it also serves the whole refresh of parallel/halo.py
// (refresh_moves: each corner read straight from the diagonal neighbour's
// cells, each panel halo and replicated panel from the iy = 0 shard of its
// column).  Every source is a shard's own cells and every destination a
// halo, so no two rectangles of a launch overlap and their order is free.
//
// Bound: memory.  It moves bytes and does no arithmetic: each rectangle is
// read once and written once.  Half the cells of a K-deep ring are y strips,
// K-float runs (y is the contiguous axis), so reads and writes there go by
// 32-byte sectors shared between neighbouring runs.
//
// Design.  The wrapper describes each rectangle in a device-side table row
// of kFields int64: source and destination addresses, planes, rows, floats
// per row, the plane and row strides (floats) of each side, whether its
// slots are 16-byte lines, the slots per row and the rectangle's first slot
// in one flat index over the launch.  A slot is one float, so that
// neighbouring lanes take neighbouring floats: a warp covers about six
// consecutive 20-byte y runs in one instruction and shares their sectors.
// A long row (at least 32 floats, an x strip or a panel) whose two sides
// share their 16-byte phase on every row goes by lines instead (the
// wrapper marks such rectangles in the table): a
// slot is the floats of the row that fall in one aligned 16-byte line, one
// float4 when it is full, a scalar head or tail else.
// - The grid fills the card once (kBlocksPerSm blocks per SM at most), and
//   each block walks one contiguous range of the flat index; no block is
//   tied to one rectangle, so a long y strip does not sit on one SM while
//   the others idle.
// - Each thread locates and loads kItems slots before it stores any, so
//   that several loads per thread are in flight.
// - The table is staged in shared memory once per block.  A block finds
//   the rectangle of each chunk's first slot by a binary search over the
//   first slots; a thread then steps forward from it to its own slots'.
// TMA's tensor copies need inner boxes of a multiple of 16 bytes, which a
// 20-byte y run is not, so the kernel uses plain loads and stores.
// A destination may be a carry on this card, on a peer card of the same
// process (peer access enabled), or of another process mapped into this one
// through CUDA IPC; the wrapper orders the launch against the readers and
// writers of those carries (events within a process, host barriers across
// processes: the TPU kernel's barrier semaphore).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// 512 threads, 4 slots each, 2 blocks per SM: the best of the shapes
// measured by scripts/torch_exchange_variants.py (fewer slots in flight, or
// more blocks per SM with their register spills, were slower).
constexpr int kThreads = 512;
constexpr int kItems = 4;             // slots each thread has in flight
constexpr int kBlocksPerSm = 2;       // resident blocks per SM (<= 64 registers)
constexpr int kFields = 12;           // int64 per rectangle in the table
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;  // a block's shared memory on Hopper

// The fields of a table row.
enum Field {
  kSrc, kDst, kPlanes, kRows, kCount, kSrcPlane, kSrcRow, kDstPlane, kDstRow,
  kVector, kSlots, kFirst
};

struct Slot {
  const float* src;
  float* dst;
  int count;  // floats in the slot, 0 to 4; 4 means one aligned float4
};

// The last rectangle whose first slot is at most i.
__device__ __forceinline__ int find(const long long* __restrict__ table, const int n_rects,
                                    const unsigned i) {
  int lo = 0, hi = n_rects - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (static_cast<unsigned>(table[mid * kFields + kFirst]) <= i) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// Slot i of the rectangle of table row `row`: its plane, row and place in
// the row.
__device__ __forceinline__ Slot locate(const long long* __restrict__ row, const unsigned i) {
  const unsigned local = i - static_cast<unsigned>(row[kFirst]);
  const unsigned slots = static_cast<unsigned>(row[kSlots]);
  const unsigned rows = static_cast<unsigned>(row[kRows]);
  const unsigned slot = local % slots;
  const unsigned line = local / slots;
  const long long r = line % rows;
  const long long p = line / rows;
  const float* src = reinterpret_cast<const float*>(row[kSrc]) + p * row[kSrcPlane] +
                     r * row[kSrcRow];
  float* dst = reinterpret_cast<float*>(row[kDst]) + p * row[kDstPlane] +
               r * row[kDstRow];
  Slot s;
  if (row[kVector] == 0) {
    s.src = src + slot;
    s.dst = dst + slot;
    s.count = 1;
    return s;
  }
  // the floats of the row in the 16-byte line `slot` (the row starts
  // `phase` floats into its first line)
  const int phase = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3u);
  const long long n = row[kCount];
  long long begin = 4ll * slot - phase;
  long long end = begin + 4;
  if (begin < 0) begin = 0;
  if (end > n) end = n;
  s.src = src + begin;
  s.dst = dst + begin;
  s.count = end > begin ? static_cast<int>(end - begin) : 0;
  return s;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
halo_exchange_kernel(const long long* __restrict__ table, const int n_rects,
                     const unsigned n_slots) {
  extern __shared__ long long table_s[];
  for (int k = threadIdx.x; k < n_rects * kFields; k += blockDim.x) {
    table_s[k] = table[k];
  }
  __syncthreads();
  // this block's contiguous range of the flat index
  const unsigned lo = static_cast<unsigned>(
      static_cast<unsigned long long>(n_slots) * blockIdx.x / gridDim.x);
  const unsigned hi = static_cast<unsigned>(
      static_cast<unsigned long long>(n_slots) * (blockIdx.x + 1) / gridDim.x);
  for (unsigned chunk = lo; chunk < hi; chunk += kItems * blockDim.x) {
    int rect = find(table_s, n_rects, chunk);
    Slot s[kItems];
    float4 v[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const unsigned i = chunk + u * blockDim.x + threadIdx.x;
      s[u].count = 0;
      if (i < hi) {
        while (rect + 1 < n_rects &&
               static_cast<unsigned>(table_s[(rect + 1) * kFields + kFirst]) <= i) {
          ++rect;
        }
        s[u] = locate(table_s + rect * kFields, i);
      }
      if (s[u].count == 4) {
        v[u] = *reinterpret_cast<const float4*>(s[u].src);
      } else {
        if (s[u].count > 0) v[u].x = s[u].src[0];
        if (s[u].count > 1) v[u].y = s[u].src[1];
        if (s[u].count > 2) v[u].z = s[u].src[2];
      }
    }
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      if (s[u].count == 4) {
        *reinterpret_cast<float4*>(s[u].dst) = v[u];
      } else {
        if (s[u].count > 0) s[u].dst[0] = v[u].x;
        if (s[u].count > 1) s[u].dst[1] = v[u].y;
        if (s[u].count > 2) s[u].dst[2] = v[u].z;
      }
    }
  }
}

}  // namespace

// Copy the n_rects rectangles of the device-side table (kFields int64 per
// rectangle, see above; n_slots slots in all) on `stream` of card `device`,
// whose `sms` SMs the grid fills once.  Makes `device` current for the
// launch and restores the current device after it.  Returns
// cudaGetLastError() after the launch.
extern "C" int lbm_halo_exchange(const void* table, int n_rects, long long n_slots,
                                 int device, int sms, void* stream) {
  const long long smem = static_cast<long long>(n_rects) * kFields * 8;
  if (n_rects < 1 || smem > kMaxSmem || n_slots < 1 || n_slots > 0x7fffffffll ||
      sms < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err == cudaSuccess && smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(halo_exchange_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err == cudaSuccess) {
    long long blocks = (n_slots + kThreads * kItems - 1) / (kThreads * kItems);
    if (blocks > static_cast<long long>(sms) * kBlocksPerSm) {
      blocks = static_cast<long long>(sms) * kBlocksPerSm;
    }
    halo_exchange_kernel<<<static_cast<unsigned>(blocks), kThreads,
                           static_cast<size_t>(smem),
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(table), n_rects,
        static_cast<unsigned>(n_slots));
    err = cudaGetLastError();
  }
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
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
