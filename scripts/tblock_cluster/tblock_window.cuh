// A design of the port's temporal-block window, measured against the
// package's (latticeboltzmannsimulations_torch/csrc/tblock_window.cuh) by
// scripts/torch_tblock_designs.py and kept here, not in the package: on the
// card it ran slower than the package's window at every size (PERF.md
// section 6).  It is the cluster window of two temporal-block kernels
// (tblock_step.cu on the whole field, tblock_sharded_step.cu on one shard's
// carry): K fused pull steps per launch, float32, for Hopper.  Both kernels
// run this one routine; they differ only in their addressing policy (Addr,
// below), which says how a window row and column are found and to which
// global cell each window cell is keyed.
//
// Bound.  A launch reads the 9 f32 planes once and writes them once for K
// steps: 72/K B of device traffic per cell per step, against about 170
// floating-point operations per cell per step; at 2048^2 and K = 5 the
// published 3.35 TB/s give 0.01803 ms a step.  On one NVIDIA H100 80GB HBM3
// at 700.00 W (scripts/torch_tblock_designs.py, PERF.md section 6) the
// window before this design, one 64 x 64 block an SM, ran 0.0847 ms a step:
// its MRT cell-step is 200 instructions, a step of 4096 cells 10 560 SM
// cycles (2.4 warp instructions a cycle), and a block's life was 20 %
// staging, 68 % steps, 12 % write-back, all SMs staging at once.  The
// halo costs 64^2 / 54^2 = 1.40 cell-steps per owned one at K = 5.  This
// window in a cluster of one ran 0.0858 ms; its middle steps 12 741 cycles
// at 192 instructions a cell (1.9 a cycle), step 1 18 559, step K 20 485.
//
// Design.  A thread-block cluster of Cx x Cy blocks holds one window of
// (R Cx) x (C Cy) cells, each block a part of R x C = 4096 cells (R = 64,
// 32 or 16 rows); the cluster owns its centre, (R Cx - 2K) x (C Cy - 2K)
// cells (a tile), and the K-deep halo that every window recomputes lies
// only at the cluster's outer edge.  Its fastest shape on the card was a
// cluster of one 64 x 64 block: every cluster of two blocks or more
// measured slower (PERF.md section 6), the cells it saves eaten by the edge
// code, the cluster's co-scheduling and a slower step.
// * Persistent: the grid holds as many clusters as the card runs at once,
//   one block of 1024 threads an SM, and each cluster steps tile after
//   tile.  A block keeps its part in dynamic shared memory (9 planes, the
//   lid densities and the first step's inbox, about 175 KB), staged by
//   cp.async (one instruction a float, no registers); while it steps a
//   tile, the next tile's part is prefetched into L2, a slice of its planes
//   a step, so that its staging reads L2 and the prefetch never bursts.
//   Step K stores the own cells' populations from registers to device
//   memory; there is no write-back pass.
// * Every window cell is keyed to its global cell: its wall masks, the lid
//   momentum with its zero at the two corners, and its lid density follow
//   the wrapped global coordinates (Addr::gx, Addr::gy), so the window is
//   an exact periodic image of the domain around the cluster's tile, and
//   after s in-window steps every cell at least s from the cluster
//   window's edge is exact.  (The y wrap shows at the lid corners, so a
//   wrapped row must evolve as the row it mirrors.)
// * One buffer per tile, no copy per step: streaming is a translation of
//   each plane, so plane k of a part is stored cyclically shifted by
//   s * (dx_k * C + dy_k) over the flat part after s steps.  Part cell
//   (i, j) then finds its 9 gathered populations at fixed addresses of step
//   s, and writes its 9 post-collision populations back to those same
//   addresses; no two cells share an address, so a step has no race.
// * At a part's edge the shift brings in values of the part's own opposite
//   edge.  Where the edge borders another block of the cluster, the value
//   that crossed it comes instead from that block: in step 1 from device
//   memory, staged with the part; after a step s < K, through distributed
//   shared memory (DSMEM): the cell that sends a population across the edge
//   also stores it into the neighbour's inbox (st.async, tblock_async.cuh),
//   completing its bytes on the neighbour's mbarrier of that step's
//   parity, and the cell that receives it waits on its own mbarrier and
//   reads its inbox in place of the shifted slot.  Within a tile no
//   barrier spans the cluster: a block waits only for the bytes its
//   neighbours send, and the rows that trade across an x edge are stepped
//   first in each step, so what they send lands long before the
//   neighbour's next step needs it; one cluster barrier a tile keeps a
//   block's next tile from sending before its neighbours have read this
//   one's.  At the cluster's outer edge the wrapped values stay, and reach
//   at most s cells inward after s steps (the trapezoid).
// * Threads run along y (the contiguous axis), 32 consecutive cells of one
//   part row per warp: the part's load and the own-cell store are
//   coalesced, the shifted rows are free of bank conflicts, and a row that
//   trades across an x edge is whole warps, so the edge path diverges only
//   where a cluster spans y (Cy > 1).
// * The lid density is carried per window cell in the tenth plane, which
//   does not stream: a lid cell reads and writes only its own slot, so two
//   images of the lid row in one window never race, and a field smaller
//   than the window is served.
// * A part that holds no wall cell (most parts of a large field) runs the
//   steps without masks or lid densities.
//
// Addr supplies, for part row i and column j (-1 <= i <= R, -1 <= j <= C:
// one beyond the part where a neighbour of the cluster lies there):
// row_off(i) + col_off(j), the cell's offset in a plane of f and f_out;
// plane, the floats of a plane; gx(i) and gy(j), its global cell; gx0 and
// gy0, the global cell of part cell (0, 0) before wrapping; lid_src(i), the
// lid density before, and lid_out(i, rho), after; and the own rows
// [row_lo, row_hi) and columns [col_lo, col_hi) of the part.  Tiles
// supplies count, the tiles of the launch, and at(tile, part), the Addr of
// a block's part of a tile.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>

#include "lbm_cell.cuh"
#include "tblock_async.cuh"

// Phase stamps of a measuring build (scripts/tblock_phases/stamps.cuh);
// nothing in a plain build.
#ifndef LBM_WINDOW_STAMP
#define LBM_WINDOW_STAMP(n)
#endif

namespace lbm {
namespace window {

namespace cg = cooperative_groups;

// v mod n for n > 0.  v lies within a window of [0, n), so one step of n is
// enough for a field at least a window wide; the integer % (about 20
// instructions on the card) runs only for a field smaller than the window.
__host__ __device__ __forceinline__ int wrap(int v, const int n) {
  v = v < 0 ? v + n : (v >= n ? v - n : v);
  if (v < 0 || v >= n) {
    v %= n;
    if (v < 0) v += n;
  }
  return v;
}

constexpr int kCells = 4096;               // cells of a block's part, a power of two
constexpr int kThreads = 1024;
constexpr int kMaxCluster = 16;            // blocks of a cluster (above 8: non-portable)
constexpr int kMinWindow = 64;             // the least window edge along either axis
constexpr unsigned char kLeft = 1, kRight = 2;    // x keys of a part row
constexpr unsigned char kBottom = 1, kLid = 2;    // y keys of a part column

// How a part trades with its cluster: not at all (a cluster of one),
// across x edges only (whole rows), or across x and y edges and corners.
enum Span { kAlone, kAlongX, kBoth };

// What crosses into a part from the neighbours of its cluster: across the
// x edge per receiving column, across the y edge per receiving row, and
// across a corner.
template <int R>
struct Edges {
  float x[9][kCells / R];
  float y[9][R];
  float d[9];
};

// One tile's part: the 9 planes, the lid densities, the populations that
// cross into it in step 1 (from device memory), and its keys.
template <int R>
struct Buffer {
  float f[9][kCells];
  float rl[kCells];
  Edges<R> first;
  unsigned char xkey[R], ykey[kCells / R];
};

// A block's dynamic shared memory: its part, and the inbox of what the
// cluster's other blocks send after a step s < K, by the parity of s, each
// parity with its mbarrier.
template <int R>
struct Smem {
  Buffer<R> buf;
  Edges<R> in[2];
  unsigned long long full[2];
};

// The block's place in its cluster: part (rx, ry) of cx x cy.
struct Part {
  int rx, ry, cx, cy;
  __device__ bool has(const int ox, const int oy) const {
    return rx + ox >= 0 && rx + ox < cx && ry + oy >= 0 && ry + oy < cy;
  }
  __device__ unsigned rank(const int ox, const int oy) const {
    return static_cast<unsigned>((rx + ox) + (ry + oy) * cx);
  }
};

__device__ __forceinline__ Part this_part() {
  const cg::cluster_group cluster = cg::this_cluster();
  const dim3 at = cluster.block_index(), dims = cluster.dim_blocks();
  return Part{static_cast<int>(at.x), static_cast<int>(at.y), static_cast<int>(dims.x),
              static_cast<int>(dims.y)};
}

// Offset in a plane of plane k's part cell c = i * C + j after s steps: the
// plane is shifted cyclically by s * (dx_k * C + dy_k) over the part.
template <int C>
__device__ __forceinline__ int slot(const int k, const int c, const int s) {
  return (c - s * (dx(k) * C + dy(k))) & (kCells - 1);
}

// Which neighbour of the part holds part row or column v: -1, 0 or 1.
template <int N>
__device__ __forceinline__ int side(const int v) {
  return v < 0 ? -1 : (v >= N ? 1 : 0);
}

// Does the population between a part cell and part cell (ti, tj) (its
// source, for one that streams in; its destination, for one that streams
// out) cross to another block of the cluster, and to which one, (ox, oy)?
template <int R, int kSpan>
__device__ __forceinline__ bool crosses(const int ti, const int tj, const Part& part, int& ox,
                                        int& oy) {
  constexpr int C = kCells / R;
  ox = side<R>(ti);
  oy = side<C>(tj);
  if (kSpan == kAlongX && oy != 0) return false;
  return (ox != 0 || oy != 0) && part.has(ox, oy);
}

// The slot of plane k for a receiving cell at row i or column j, from the
// neighbour (ox, oy).
template <int R>
__device__ __forceinline__ float* edge_at(Edges<R>& e, const int k, const int ox,
                                          const int oy, const int i, const int j) {
  return ox != 0 && oy != 0 ? &e.d[k] : (ox != 0 ? &e.x[k][j] : &e.y[k][i]);
}

// Issue the copies of a tile's part into buffer b (one cp.async a float;
// the caller commits them): the planes unshifted (step 0), the lid
// densities of lid cells, the populations that cross into the part in
// step 1, and the keys.
template <int R, class Addr>
__device__ __forceinline__ void stage(const Addr& a, const Part& part, Buffer<R>& b,
                                      const float* __restrict__ f, const Params& p) {
  constexpr int C = kCells / R;
  for (int i = threadIdx.x; i < R; i += kThreads) {
    const int gx = a.gx(i);
    b.xkey[i] = (gx == 0 ? kLeft : 0) | (gx == p.nx - 1 ? kRight : 0);
  }
  for (int j = threadIdx.x; j < C; j += kThreads) {
    const int gy = a.gy(j);
    b.ykey[j] = (gy == p.ny - 1 ? kBottom : 0) | (gy == 0 ? kLid : 0);
  }
  const int i_lo = part.has(-1, 0) ? 0 : -1, i_hi = part.has(1, 0) ? R - 1 : -1;
  const int j_lo = part.has(0, -1) ? 0 : -1, j_hi = part.has(0, 1) ? C - 1 : -1;
#pragma unroll
  for (int c = threadIdx.x; c < kCells; c += kThreads) {
    const int i = c / C, j = c % C;
    const size_t src = a.row_off(i) + a.col_off(j);
#pragma unroll
    for (int k = 0; k < 9; ++k) async::copy(&b.f[k][c], f + k * a.plane + src);
    if (a.gy(j) == 0) async::copy(&b.rl[c], a.lid_src(i));   // only lid cells read it
    if (i == i_lo || i == i_hi || j == j_lo || j == j_hi) {
#pragma unroll
      for (int k = 1; k < 9; ++k) {
        const int si = i - dx(k), sj = j - dy(k);
        int ox, oy;
        if (crosses<R, kBoth>(si, sj, part, ox, oy)) {
          async::copy(edge_at<R>(b.first, k, ox, oy, i, j),
                      f + k * a.plane + a.row_off(si) + a.col_off(sj));
        }
      }
    }
  }
}

// Step s of every cell of the part, the block's n-th tile.  Rows R - 1 and
// 0 come first (they are among the first kThreads cells of the rotated
// order, since C <= 256), so that what crosses an x edge leaves early.  A
// cell on an edge shared with another block takes the populations that
// cross it from the buffer's first-step edges in step 1, and from the
// inbox after: a thread with such a cell waits, before it, for the bytes
// its neighbours sent in step s - 1, on the mbarrier of that parity; before
// step K it sends its own across, onto the neighbours' mbarriers of step
// s's parity, which each block arms once a step (thread 0, the bytes it
// expects).  An inbox parity is not written again before it is read: a
// block sends a later step's values of that parity only after the
// neighbour's values of the step between have landed, which each of the
// neighbour's edge cells sent after reading.  Step K (kLast) stores the
// own cells to device memory through *a (the last cluster of a row or
// column may reach past the field or shard); the steps before it need no
// addressing, so that their loop holds no more registers than the cell's.
template <int R, bool kWalls, int kSpan, bool kLast, class Addr>
__device__ __forceinline__ void one_step(const Addr* a, const Part& part, Smem<R>& sm,
                                         const int s, const int tile_n,
                                         float* __restrict__ f_out, const Params& p,
                                         const int k_steps, const unsigned in_bytes) {
  constexpr int C = kCells / R;
  Buffer<R>& b = sm.buf;
  const int i_lo = part.has(-1, 0) ? 0 : -1, i_hi = part.has(1, 0) ? R - 1 : -1;
  const int j_lo = part.has(0, -1) ? 0 : -1, j_hi = part.has(0, 1) ? C - 1 : -1;
  const int rd = (s - 1) & 1, wr = s & 1;
  if (kSpan != kAlone && !kLast && threadIdx.x == 0) {
    async::bar_expect(&sm.full[wr], in_bytes);
  }
  bool waited = s == 1;
  for (int n = threadIdx.x; n < kCells; n += kThreads) {
    const int c = (n + (R - 1) * C) & (kCells - 1);
    const int i = c / C, j = c % C;
    float g[9], o[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) g[k] = b.f[k][slot<C>(k, c, s)];
    bool edge = false;
    if (kSpan != kAlone) {
      edge = i == i_lo || i == i_hi || (kSpan == kBoth && (j == j_lo || j == j_hi));
      if (edge) {
        if (!waited) {
          // the sends of a tile on parity rd: its odd steps below K (rd 1)
          // or its even ones (rd 0); the one read now is the tile's
          // (s - 2) / 2-th
          const int sends = rd ? k_steps / 2 : (k_steps - 1) / 2;
          async::bar_wait(&sm.full[rd], (tile_n * sends + ((s - 2) >> 1)) & 1);
          waited = true;
        }
        Edges<R>& from = s == 1 ? b.first : sm.in[rd];
#pragma unroll
        for (int k = 1; k < 9; ++k) {
          int ox, oy;
          if (crosses<R, kSpan>(i - dx(k), j - dy(k), part, ox, oy)) {
            g[k] = *edge_at<R>(from, k, ox, oy, i, j);
          }
        }
      }
    }
    bool lid = false;
    float rho = 0.0f;
    if (kWalls) {
      const unsigned char col = b.xkey[i], row = b.ykey[j];
      const bool left = col & kLeft, right = col & kRight;
      lid = row & kLid;
      const float rlp = (lid && !(left || right)) ? b.rl[c] : 0.0f;
      rho = fused_cell(g, left, right, row & kBottom, lid, rlp, nullptr, p, o);
    } else {
      fused_cell(g, false, false, false, false, 0.0f, nullptr, p, o);
    }
    if (kLast) {
      if (i >= a->row_lo && i < a->row_hi && j >= a->col_lo && j < a->col_hi) {
        const size_t dst = a->row_off(i) + a->col_off(j);
#pragma unroll
        for (int k = 0; k < 9; ++k) f_out[k * a->plane + dst] = o[k];
        if (lid) a->lid_out(i, rho);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 9; ++k) b.f[k][slot<C>(k, c, s)] = o[k];
      if (lid) b.rl[c] = rho;
      if (kSpan != kAlone && edge) {
#pragma unroll
        for (int k = 1; k < 9; ++k) {
          const int ti = i + dx(k), tj = j + dy(k);
          int ox, oy;
          if (crosses<R, kSpan>(ti, tj, part, ox, oy)) {
            async::send(edge_at<R>(sm.in[wr], k, ox, oy, ti, tj), &sm.full[wr],
                        part.rank(ox, oy), o[k]);
          }
        }
      }
    }
  }
  // the next step (or the next tile's staging) reads what other threads of
  // the block wrote
  __syncthreads();
}

// Prefetch into L2 the planes `slice`, slice + K, ... of a tile's part: the
// lines of the first and the last cell of each run of 32 cells of a part
// row.  Step s of a tile prefetches slice s - 1 of the next one, so that
// the next part's reads from device memory spread over the K steps.
template <int R, class Addr>
__device__ __forceinline__ void prefetch(const Addr& a, const float* __restrict__ f,
                                         const int slice, const int k_steps) {
  constexpr int C = kCells / R, kRuns = C / 32;
  for (int k = slice; k < 9; k += k_steps) {
    for (int t = threadIdx.x; t < R * kRuns; t += kThreads) {
      const int i = t / kRuns, q = t % kRuns;
      const float* const row = f + k * a.plane + a.row_off(i);
      async::prefetch_l2(row + a.col_off(32 * q));
      async::prefetch_l2(row + a.col_off(32 * q + 31));
    }
  }
}

// The K steps of the block's n-th tile (staged), while the next one, if
// any, is prefetched.
template <int R, bool kWalls, int kSpan, class Tiles>
__device__ __forceinline__ void tile_steps(const Tiles& tiles, const int tile,
                                           const int next, const Part& part, Smem<R>& sm,
                                           const int n, const float* __restrict__ f,
                                           float* __restrict__ f_out, const Params& p,
                                           const int k_steps, const unsigned in_bytes) {
  using Addr = decltype(tiles.at(tile, part));
  for (int s = 1; s < k_steps; ++s) {
    if (next < tiles.count) prefetch<R>(tiles.at(next, part), f, s - 1, k_steps);
    one_step<R, kWalls, kSpan, false>(static_cast<const Addr*>(nullptr), part, sm, s, n,
                                      f_out, p, k_steps, in_bytes);
    if (n == 0) LBM_WINDOW_STAMP(1 + s);
  }
  if (next < tiles.count) prefetch<R>(tiles.at(next, part), f, k_steps - 1, k_steps);
  const Addr a = tiles.at(tile, part);
  one_step<R, kWalls, kSpan, true>(&a, part, sm, k_steps, n, f_out, p, k_steps, in_bytes);
  if (n == 0) LBM_WINDOW_STAMP(1 + k_steps);
}

// The populations that cross into the part in a step, as bytes: 3C - 2
// across each x edge shared with a neighbour (three planes, less the two
// whose source lies past the edge's ends), 3R - 2 across each such y edge,
// and one at each corner shared with a diagonal neighbour.
template <int R>
__device__ __forceinline__ unsigned inbox_bytes(const Part& part) {
  constexpr int C = kCells / R;
  unsigned count = 0;
  for (int o = -1; o <= 1; o += 2) {
    count += (part.has(o, 0) ? 3 * C - 2 : 0) + (part.has(0, o) ? 3 * R - 2 : 0) +
             (part.has(o, -1) ? 1 : 0) + (part.has(o, 1) ? 1 : 0);
  }
  return count * static_cast<unsigned>(sizeof(float));
}

template <int R, int kSpan, class Tiles>
__device__ __forceinline__ void span_steps(const bool walls, const Tiles& tiles,
                                           const int tile, const int next,
                                           const Part& part, Smem<R>& sm, const int n,
                                           const float* __restrict__ f,
                                           float* __restrict__ f_out, const Params& p,
                                           const int k_steps, const unsigned in_bytes) {
  if (walls) {
    tile_steps<R, true, kSpan>(tiles, tile, next, part, sm, n, f, f_out, p, k_steps,
                               in_bytes);
  } else {
    tile_steps<R, false, kSpan>(tiles, tile, next, part, sm, n, f, f_out, p, k_steps,
                                in_bytes);
  }
}

// The block's tiles, one after another: cluster u of the grid's clusters
// steps tiles u, u + clusters, ...; while it steps one, the next one's part
// is prefetched into L2.
template <int R, class Tiles>
__device__ __forceinline__ void window_run(const Tiles& tiles, const float* __restrict__ f,
                                           float* __restrict__ f_out, const Params& p,
                                           const int k_steps) {
  constexpr int C = kCells / R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<R>& sm = *reinterpret_cast<Smem<R>*>(smem_raw);
  const Part part = this_part();
  const int across = gridDim.x / part.cx;
  const int cluster = (blockIdx.y / part.cy) * across + blockIdx.x / part.cx;
  const int clusters = across * (gridDim.y / part.cy);
  LBM_WINDOW_STAMP(0);
  if (threadIdx.x == 0) {
    async::bar_init(&sm.full[0]);
    async::bar_init(&sm.full[1]);
  }
  // Every block of the cluster has set up its mbarriers before any stores
  // into them, and, before a tile's first step, has read everything its
  // neighbours sent it in the tile before (the tile's sends restart on
  // parities read in the one before): a cluster barrier at each tile,
  // arrived at after the steps and waited for after the next staging.
  async::cluster_arrive();
  const unsigned in_bytes = inbox_bytes<R>(part);
  const int span = part.cx * part.cy == 1 ? kAlone : (part.cy == 1 ? kAlongX : kBoth);
  int n = 0;
  for (int tile = cluster; tile < tiles.count; tile += clusters, ++n) {
    bool walls;
    {
      const auto a = tiles.at(tile, part);
      stage<R>(a, part, sm.buf, f, p);
      // Does the part (unwrapped) hold a cell of any wall?
      walls = a.gx0 < 1 || a.gx0 + R > p.nx - 1 || a.gy0 < 1 || a.gy0 + C > p.ny - 1;
    }
    async::commit();
    async::wait_all();
    async::cluster_wait();
    __syncthreads();
    if (n == 0) LBM_WINDOW_STAMP(1);
    const int next = tile + clusters;
    if (span == kAlone) {
      span_steps<R, kAlone>(walls, tiles, tile, next, part, sm, n, f, f_out, p, k_steps,
                            in_bytes);
    } else if (span == kAlongX) {
      span_steps<R, kAlongX>(walls, tiles, tile, next, part, sm, n, f, f_out, p, k_steps,
                             in_bytes);
    } else {
      span_steps<R, kBoth>(walls, tiles, tile, next, part, sm, n, f, f_out, p, k_steps,
                           in_bytes);
    }
    async::cluster_arrive();
  }
  // (and no block leaves while a neighbour may still store into it)
  async::cluster_wait();
  LBM_WINDOW_STAMP(2 + k_steps);
}

// The own cells of a cluster along one axis: [K, K + len) of the cluster's
// window, len = min(own, extent - first), as the range of part `r`'s own
// rows or columns, `n` cells a part.
struct OwnRange {
  int lo, hi;
};
__device__ __forceinline__ OwnRange own_range(const int k, const int own, const int first,
                                              const int extent, const int r, const int n) {
  const int len = min(own, extent - first), at = r * n;
  return OwnRange{max(0, k - at), min(n, k + len - at)};
}

// Is the part shape (R part rows, a cx x cy cluster) one this window runs
// at K steps: R of 64, 32 or 16, at most kMaxCluster blocks, a window of at
// least kMinWindow cells along each axis, and 2K below that?
inline bool shape_ok(const int rows, const int cx, const int cy, const int k_steps) {
  if (rows != 64 && rows != 32 && rows != 16) return false;
  if (cx < 1 || cy < 1 || cx * cy > kMaxCluster) return false;
  const int wx = rows * cx, wy = (kCells / rows) * cy;
  return wx >= kMinWindow && wy >= kMinWindow && k_steps >= 1 && 2 * k_steps < kMinWindow;
}

// The launch configuration of clusters of cx x cy blocks over a grid of
// gx x gy blocks, after asking for the kernel's shared memory and, above 8
// blocks, for a non-portable cluster.
template <int R, class... Params_>
inline cudaError_t configure(void (*kernel)(Params_...), const int cx, const int cy,
                             const int gx, const int gy, cudaStream_t stream,
                             cudaLaunchConfig_t* config, cudaLaunchAttribute* attr) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(sizeof(Smem<R>)));
  if (err == cudaSuccess && cx * cy > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cx;
  attr->val.clusterDim.y = cy;
  attr->val.clusterDim.z = 1;
  *config = cudaLaunchConfig_t{};
  config->gridDim = dim3(gx, gy, 1);
  config->blockDim = dim3(kThreads, 1, 1);
  config->dynamicSmemBytes = sizeof(Smem<R>);
  config->stream = stream;
  config->attrs = attr;
  config->numAttrs = 1;
  return err;
}

// How many clusters of cx x cy blocks of `kernel` the card holds at once
// (0: none), into *out.  Returns a cudaError_t as an int.
template <int R, class... Params_>
inline int max_clusters(void (*kernel)(Params_...), const int cx, const int cy, int* out) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<R>(kernel, cx, cy, cx, cy, nullptr, &config, &attr);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(out, kernel, &config);
  return static_cast<int>(err);
}

// Launch kernel(args...) as min(tiles, the clusters the card holds at
// once) clusters of cx x cy blocks, along x.  The count the card holds is
// asked once per kernel and cluster shape (and kept: every card of a run
// is the same model).  Returns a cudaError_t as an int.
template <int R, class... Params_, class... Args>
inline int launch(void (*kernel)(Params_...), const int cx, const int cy, const int tiles,
                  cudaStream_t stream, Args... args) {
  static std::atomic<int> held[kMaxCluster + 1][kMaxCluster + 1];
  int at_once = held[cx][cy].load();
  if (at_once == 0) {
    const int err = max_clusters<R>(kernel, cx, cy, &at_once);
    if (err != 0) return err;
    if (at_once < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    held[cx][cy].store(at_once);
  }
  const int clusters = tiles < at_once ? tiles : at_once;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<R>(kernel, cx, cy, clusters * cx, cy, stream, &config, &attr);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace window
}  // namespace lbm
