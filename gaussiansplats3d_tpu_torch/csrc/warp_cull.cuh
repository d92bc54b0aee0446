// Per-warp pair cull and pixel layout, shared by the compositors B1-B4 of
// the port (composite_fwd.cu, composite_bwd.cu, surfel_fwd.cu,
// surfel_bwd.cu) and the ablation bench B5 (kernel_bench.cu), the
// per-pair warp reduction of the backward ones (B2, B4), the cluster of
// four blocks that holds a tile of side 33-64, and the walk of one block
// over the 32 x 32 sub-tiles of a tile of side 65 or more.
//
// The layout: the kernels' template parameter Q, chosen by the side alone
// (layout()).  A tile of side ts <= 32 is one block of warps(ts) warps (Q
// = 1).  A tile of side 33..64 (kMaxQuadTile) is a thread-block cluster of
// kQuads = 4 blocks (Q = kQuads): block r of the cluster
// (cluster.block_rank()) holds the 32 x 32 quadrant (r % 2, r / 2),
// columns [32 (r % 2), min(32 (r % 2) + 32, ts)) and rows [32 (r / 2),
// min(32 (r / 2) + 32, ts)), as a tile-32 block holds its tile: 16 warps,
// each on an 8 x 8 patch.  A tile of side 65 or more is one block of 16
// warps (Q = kWalk) that walks its g x g sub-tiles of 32 x 32, g =
// ceil(ts / 32), in row-major order: on sub-tile s, columns [32 (s % g),
// min(32 (s % g) + 32, ts)) and the same rows of s / g, its warps hold the
// patches a cluster block holds on a quadrant (the quadrant geometry with
// s % g, s / g for r % 2, r / 2).  The quadrants and sub-tiles start at
// multiples of 32, so their patches inside the tile are those of an 8 x 8
// patching of the whole tile (the mirror's warp_rects).  A launch has one
// block size, so a narrow quadrant or sub-tile (8 wide at side 40) keeps
// its 16 warps: a warp whose patch lies wholly past the tile's edge holds
// no pixel and keeps an empty mask (held()), but it stages and reaches
// every barrier.  Pixels keep the whole tile's coordinates, p = iy * ts +
// ix.
//
// The cluster.  The forward kernels (B1, B3, B5) stop a tile once no pixel
// of any of its blocks is alive: each block takes __syncthreads_or, writes
// the flag into a slot of every block's shared memory (distributed shared
// memory, DSMEM), and after cluster.sync() every block reads the four
// flags (cluster_any).  The backward ones (B2, B4) add the four blocks'
// per-chunk sums: block r sums lanes [32 r, 32 r + 32) of every block's
// sacc through DSMEM and writes those slots (cluster_write), so each slot
// is still written once.
//
// The walk.  A forward kernel stops a tile after the first chunk at which
// no pixel of the whole tile is alive.  T never grows, so that chunk is
// the largest of the sub-tiles' own exit chunks, K = max_s k_s, and each
// pixel's arithmetic depends on no other pixel.  walk_forward runs the
// sub-tiles in order, each voting over its own pixels (__syncthreads_or)
// but only from the tile's exit so far on, and writes their outputs.  The
// sub-tiles before the last one that raised that exit stopped short of K,
// and only they: they run again from chunk 0 to K and overwrite their
// outputs.  Every pixel then took K chunks, the sequence of adds of one
// whole-tile vote.  The backward ones (B2, B4)
// replay the tile's chunks from its exit_k for each sub-tile in order, as
// a tile-32 block does, and walk_write adds each chunk's sums into the
// pair's slots: sub-tile 0 writes them, the later ones add theirs.  A slot
// lies in one tile's window, so only this block touches it, in an order
// the loop and the block's barriers fix: no global atomics, no scratch.
//
// The cull.  A warp holds an 8 x 8 patch of its tile (pixel()), whose
// pixel centres lie in a rectangle (Rect).  Once a 128-pair chunk is
// staged in shared memory, each warp tests the chunk's pairs against its
// rectangle, one pair a lane in four ballots, and keeps a 128-bit mask
// (Mask).  The test is a superset of the per-pixel box test |px - x| <= rx,
// |py - y| <= ry the kernels still make at every visit: a pair it drops
// fails the box test at every pixel of the warp, so walking the mask's set
// bits in order (ascending, descending) visits, at each pixel, exactly the
// pairs the full walk would have let through the box test, in the same
// order.  A replayed sum over them is therefore the same sequence of adds.
// The mirror in render/cuda_rasterize.py (warp_keep) computes the same
// predicate for the work counts and the tests.
//
// The reduction.  For a pair that some lane of the warp evaluates, the
// warp sums each of its N <= 16 gradient terms over its lanes with one
// shuffle-xor halving reduce-scatter: at offsets 16, 8, 4 and 2 each lane
// keeps one half of its terms, hands the other half to its partner and
// adds what the partner handed it; offset 1 then sums the one term left.
// That is ceil(N/2) + ... + 1 + 1 shuffles (12 for N = 9 or 10, 16 for 15
// or 16) in place of N five-step trees, and afterwards each term's warp
// total sits on a lane of its own (reduced_term), so the lanes add into
// shared memory in parallel.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace warp_cull {

namespace cg = cooperative_groups;

constexpr int kChunk = 128;
constexpr int kWords = kChunk / 32;
constexpr unsigned kFull = 0xffffffffu;
// Row stride of the per-chunk sums sacc[term][lane] in shared memory: one
// more than the chunk, so the lanes that add the terms of one pair (one
// term each, the same chunk lane) hit different banks.
constexpr int kAccStride = kChunk + 1;

// Pixel centres x0..x1, y0..y1 (GL: corner + index + 0.5).
struct Rect {
  float x0, x1, y0, y1;
};

// Which pixels a warp holds.  Each lane holds kPix = 2 pixels, and the
// warps tile the tile with kPatch x kPatch = 8 x 8 patches, row-major: lane
// l holds the pixels (l % 8, l / 8) and (l % 8, l / 8 + 4) of its patch, so
// a pair's box covers few warps and many of their lanes.  Pixels past the
// tile's edge are not held (inside() is false).  The mirror in
// render/cuda_rasterize.py (WARP_PATCH, warp_rects) lays the warps out the
// same way.
constexpr int kPix = 2;
constexpr int kPatch = 8;
constexpr int kPatchRowsPerQ = 32 / kPatch;  // rows of one pixel a lane
static_assert(kPatchRowsPerQ * kPix == kPatch, "square patches");

// A cluster's quadrants: the side of each, how many, the largest tile of
// a cluster; above it a block walks sub-tiles of side kQuadSide (Q =
// kWalk).
constexpr int kQuadSide = 32;
constexpr int kQuads = 4;
constexpr int kMaxQuadTile = 2 * kQuadSide;
constexpr int kWalk = 0;

// warps that cover a ts x ts tile
__host__ __device__ inline int warps(int ts) {
  const int across = (ts + kPatch - 1) / kPatch;
  return across * across;
}

// The layout (Q) of a tile of side ts: 1 block up to 32, a cluster of
// kQuads up to kMaxQuadTile, one block walking its sub-tiles (kWalk)
// above.
__host__ __device__ inline int layout(int ts) {
  return ts <= kQuadSide ? 1 : ts <= kMaxQuadTile ? kQuads : kWalk;
}

// The 32 x 32 sub-tiles a Q = kWalk block walks: g x g, g = ceil(ts / 32).
__host__ __device__ inline int sub_tiles(int ts) {
  const int g = (ts + kQuadSide - 1) / kQuadSide;
  return g * g;
}

// Threads of a block of a tile of side ts (whole warps: the cull's
// ballots and the sweep's collectives).
__host__ __device__ inline int threads(int ts) {
  return warps(ts <= kQuadSide ? ts : kQuadSide) * 32;
}

// Column c0 and row r0 in the tile of warp `warp`'s patch corner.  Q = 1:
// the block holds the whole tile, ceil(ts / 8)^2 patches row-major; Q =
// kQuads: block `quad` of the cluster holds its quadrant, 4 x 4 patches
// row-major from the quadrant's corner; Q = kWalk: the block is on
// sub-tile `quad`, 4 x 4 patches row-major from the sub-tile's corner.
template <int Q>
__device__ __forceinline__ void patch(int ts, int quad, int warp, int& c0,
                                      int& r0) {
  if constexpr (Q == 1) {
    const int across = (ts + kPatch - 1) / kPatch;
    c0 = warp % across * kPatch;
    r0 = warp / across * kPatch;
  } else if constexpr (Q == kQuads) {
    constexpr int across = kQuadSide / kPatch;
    c0 = quad % 2 * kQuadSide + warp % across * kPatch;
    r0 = quad / 2 * kQuadSide + warp / across * kPatch;
  } else {
    constexpr int across = kQuadSide / kPatch;
    const int g = (ts + kQuadSide - 1) / kQuadSide;
    c0 = quad % g * kQuadSide + warp % across * kPatch;
    r0 = quad / g * kQuadSide + warp / across * kPatch;
  }
}

// column and row in the tile of pixel q of `lane` in warp `warp` (of
// cluster block `quad` where Q = kQuads, on sub-tile `quad` where Q =
// kWalk)
template <int Q = 1>
__device__ __forceinline__ void pixel(int ts, int warp, int q, int lane,
                                      int& ix, int& iy, int quad = 0) {
  int c0, r0;
  patch<Q>(ts, quad, warp, c0, r0);
  ix = c0 + lane % kPatch;
  iy = r0 + q * kPatchRowsPerQ + lane / kPatch;
}

__device__ __forceinline__ bool inside(int ts, int ix, int iy) {
  return ix < ts && iy < ts;
}

// Whether warp `warp`'s patch holds a pixel of the tile: always with Q =
// 1; with Q = kQuads or kWalk not where the patch lies wholly past the
// tile's edge (a narrow quadrant or sub-tile).  Such a warp must keep an
// empty mask.
template <int Q>
__device__ __forceinline__ bool held(int ts, int quad, int warp) {
  if constexpr (Q == 1) {
    return true;
  } else {
    int c0, r0;
    patch<Q>(ts, quad, warp, c0, r0);
    return c0 < ts && r0 < ts;
  }
}

// the rectangle of the pixel centres of warp `warp`'s patch, clipped to
// the tile, in a tile whose corner is at (tx, ty)
template <int Q = 1>
__device__ __forceinline__ Rect rect(float tx, float ty, int ts, int warp,
                                     int quad = 0) {
  int c0, r0;
  patch<Q>(ts, quad, warp, c0, r0);
  const int c1 = min(c0 + kPatch, ts) - 1;
  const int r1 = min(r0 + kPatch, ts) - 1;
  return {tx + static_cast<float>(c0) + 0.5f,
          tx + static_cast<float>(c1) + 0.5f,
          ty + static_cast<float>(r0) + 0.5f,
          ty + static_cast<float>(r1) + 0.5f};
}

// Whether a pair centred at (x, y) with box half-widths (rx, ry) may pass
// the box test at some pixel centre of r.  The per-pixel test rounds px -
// x; a slack of one pixel, grown with the magnitudes, covers that.  Every
// comparison with a NaN is false, so a NaN keeps the pair and the
// per-pixel test decides it.  Round-to-nearest intrinsics (no FMA) keep
// it the mirror's (cuda_rasterize.warp_keep) bit for bit.
__device__ __forceinline__ bool may_touch(float x, float y, float rx,
                                          float ry, const Rect& r) {
  const float sx =
      __fadd_rn(1.0f, __fmul_rn(1e-5f, __fadd_rn(fabsf(x), fabsf(rx))));
  const float sy =
      __fadd_rn(1.0f, __fmul_rn(1e-5f, __fadd_rn(fabsf(y), fabsf(ry))));
  return !(__fsub_rn(__fsub_rn(x, rx), sx) > r.x1 ||
           __fadd_rn(__fadd_rn(x, rx), sx) < r.x0 ||
           __fsub_rn(__fsub_rn(y, ry), sy) > r.y1 ||
           __fadd_rn(__fadd_rn(y, ry), sy) < r.y0);
}

// Bit b of word j: the chunk's lane j * 32 + b.
struct Mask {
  unsigned w[kWords];
};

// The staged chunk's lanes in the window [lo, hi) that may touch the
// warp's rectangle.  cx, cy, rx, ry: the chunk's centre and box rows in
// shared memory.  Every lane of the warp must call it (ballots).
__device__ __forceinline__ Mask cull(const float* cx, const float* cy,
                                     const float* rx, const float* ry,
                                     int lo, int hi, const Rect& r,
                                     int lane) {
  Mask m;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const int l = j * 32 + lane;
    m.w[j] = __ballot_sync(
        kFull, l >= lo && l < hi && may_touch(cx[l], cy[l], rx[l], ry[l], r));
  }
  return m;
}

// Word j of the mask, by selects rather than a runtime index, so the
// mask stays in registers.  Walk the kept lanes ascending as
//   for (int j = 0; j < kWords; ++j)
//     for (unsigned bits = word(m, j); bits != 0;)
//       l = j * 32 + pop_lowest(bits) ...
// and descending from j = kWords - 1 with pop_highest.  The mask is the
// warp's, so every lane takes the same steps.
__device__ __forceinline__ unsigned word(const Mask& m, int j) {
  return j == 0 ? m.w[0] : j == 1 ? m.w[1] : j == 2 ? m.w[2] : m.w[3];
}

// The lowest set bit of w, cleared.
__device__ __forceinline__ int pop_lowest(unsigned& w) {
  const int b = __ffs(w) - 1;
  w &= w - 1;
  return b;
}

// The highest set bit of w, cleared.
__device__ __forceinline__ int pop_highest(unsigned& w) {
  const int b = 31 - __clz(w);
  w &= ~(1u << b);
  return b;
}

// One level of the reduce-scatter over v[0, N) at offset Off, then the
// levels below it; returns the total the lane is left with.
template <int N, int Off>
__device__ __forceinline__ float reduce_level(const float* v, int lane) {
  if constexpr (N == 1) {
    float s = v[0];
#pragma unroll
    for (int off = Off; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
    return s;
  } else {
    constexpr int kHalf = (N + 1) / 2;
    const bool upper = (lane & Off) != 0;
    float kept[kHalf];
#pragma unroll
    for (int k = 0; k < kHalf; ++k) {
      const float lower_v = v[k];
      const float upper_v = kHalf + k < N ? v[kHalf + k] : 0.0f;
      kept[k] = (upper ? upper_v : lower_v) +
                __shfl_xor_sync(kFull, upper ? lower_v : upper_v, Off);
    }
    return reduce_level<kHalf, Off / 2>(kept, lane);
  }
}

// The term whose warp total reduce_level<N, 16> leaves on `lane`, or -1
// where the lane is left with padding (an odd half is padded with a 0) or
// with a copy of a lower lane's total (the final butterfly).  A function
// of the lane alone: compute it once.
template <int N>
__device__ __forceinline__ int reduced_term(int lane) {
  static_assert(N >= 1 && N <= 16, "at most 16 terms");
  int term = 0, real = N, n = N, off = 16;
  for (; n > 1; off >>= 1) {
    const int half = (n + 1) / 2;
    if (lane & off) {
      term += half;
      real = real > half ? real - half : 0;
    } else {
      real = real < half ? real : half;
    }
    n = half;
  }
  // the butterfly summed over the offsets below the last halving
  return real > 0 && (lane & (2 * off - 1)) == 0 ? term : -1;
}

// Adds the warp totals of v[0, N) (N <= 16) into acc[t * kAccStride + l]:
// one shared-memory atomicAdd per term, by the lane that reduced_term<N>
// names (`term`), skipped where the total is 0.  Every lane of the warp
// must call it.
template <int N>
__device__ __forceinline__ void reduce_add(const float (&v)[N], int lane,
                                           int term, float* acc, int l) {
  const float s = reduce_level<N, 16>(v, lane);
  if (term >= 0 && s != 0.0f) atomicAdd(&acc[term * kAccStride + l], s);
}

// The tile and, with Q = kQuads, the block's quadrant (its rank in the
// cluster); a cluster's kQuads blocks are consecutive in x.  Q = 1 and
// kWalk: one block a tile, quad 0.
template <int Q>
__device__ __forceinline__ int tile_of_block(int& quad) {
  if constexpr (Q != kQuads) {
    quad = 0;
    return blockIdx.x;
  } else {
    quad = static_cast<int>(cg::this_cluster().block_rank());
    return blockIdx.x / Q;
  }
}

// With Q = kQuads, a cluster barrier before a block's first write into a
// peer's shared memory: every block of the cluster has then started.
template <int Q>
__device__ __forceinline__ void cluster_start() {
  if constexpr (Q == kQuads) cg::this_cluster().sync();
}

// The forward kernels' exit vote over a cluster, after chunk k (k counts
// from 1): whether any pixel of any of the kQuads blocks is alive.  Every
// thread of every block must call it, with the same k.  Each block takes
// __syncthreads_or; threads 0..kQuads-1 write its flag into its slot of
// every block's votes (DSMEM); after cluster.sync() (which orders those
// writes before the reads) every block reads the four flags from its own
// shared memory.  The slots are double-buffered by k & 1: the next vote's
// writes go to the other buffer, and the one after can write this buffer
// only once every block has passed the next vote's barrier, after its
// reads.  The kernel must have called cluster.sync() once before the first
// vote (cluster_start), so that no write reaches a block that has not
// started.
__device__ __forceinline__ bool cluster_any(bool alive, int k) {
  __shared__ int votes[2][kQuads];
  cg::cluster_group cluster = cg::this_cluster();
  const int mine = __syncthreads_or(alive);
  const int buf = k & 1;
  if (threadIdx.x < kQuads) {
    *cluster.map_shared_rank(&votes[buf][cluster.block_rank()],
                             threadIdx.x) = mine;
  }
  cluster.sync();
  return (votes[buf][0] | votes[buf][1] | votes[buf][2] | votes[buf][3]) != 0;
}

// The backward kernels' write of one chunk's sums over a cluster: every
// block's sacc [NT][kAccStride] holds its quadrant's sums of the chunk's
// lanes; block r adds lanes [32 r, 32 r + 32) of the kQuads blocks' sacc,
// in rank order, through DSMEM, and writes those of the window [lo, hi) to
// grad [NT, s_total] at slot base + lane.  Every thread of every block
// must call it.  cluster.sync() before (every block's sums are complete)
// and after (no block clears or refills its sacc, or exits, while a peer
// reads it).
template <int NT>
__device__ __forceinline__ void cluster_write(const float* sacc,
                                              float* __restrict__ grad,
                                              long long s_total,
                                              long long base, int lo,
                                              int hi) {
  constexpr int kLanes = kChunk / kQuads;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int r = static_cast<int>(cluster.block_rank());
  for (int i = threadIdx.x; i < NT * kLanes; i += blockDim.x) {
    const int f = i / kLanes;
    const int l = r * kLanes + i % kLanes;
    if (l < lo || l >= hi) continue;
    float sum = 0.0f;
#pragma unroll
    for (int b = 0; b < kQuads; ++b) {
      sum += cluster.map_shared_rank(sacc, b)[f * kAccStride + l];
    }
    grad[f * s_total + base + l] = sum;
  }
  cluster.sync();
}

// One sub-tile pass of walk_forward, kept out of line.  Inlined into the
// walk's loop, the surfel forward (B3) came out wrong on an H100 with nvcc
// 12.9 at ptxas -O1 and above (log T off, the tile's exit late); out of
// line, or at -Xptxas -O0, it matched its plain version at every side.
// The call passes the pass's captures through local memory.
template <typename Part>
__device__ __noinline__ int walk_pass(Part& part, int sub, int kmin) {
  return part(sub, kmin);
}

// A forward kernel's (B1, B3, B5) pass over a tile: part(quad, kmin)
// composites the pixels of quadrant or sub-tile `quad` from chunk 0,
// writes their outputs and returns the chunks it composited.  At Q = 1
// and kQuads one call, part(quad, 0), whose vote ignores kmin.  At Q =
// kWalk (warp_cull.cuh: the walk) part must stop after the first of its
// votes at or past chunk kmin at which none of its pixels is alive; each
// sub-tile runs with kmin the largest count so far, K, and the sub-tiles
// before the last one that raised K run again with kmin = K (their own
// exits lie before K, so they stop at K).  Returns the tile's exit_k.
// Every thread of the block must call it.
template <int Q, typename Part>
__device__ __forceinline__ int walk_forward(int ts, int quad, Part&& part) {
  if constexpr (Q != kWalk) {
    return part(quad, 0);
  } else {
    const int subs = sub_tiles(ts);
    int kk = 0, redo = 0;
    for (int i = 0; i < subs + redo; ++i) {
      const int sub = i < subs ? i : i - subs;
      const int k = walk_pass(part, sub, kk);
      if (i < subs && k > kk) {
        kk = k;
        redo = sub;
      }
    }
    return kk;
  }
}

// A backward kernel's (B2, B4) pass over a tile: part(quad, first) replays
// the tile's chunks for the pixels of quadrant or sub-tile `quad`; first
// says whether its sums are the first written to the window's slots.  At
// Q = 1 and kQuads one call; at Q = kWalk one a sub-tile, in order.
template <int Q, typename Part>
__device__ __forceinline__ void walk_backward(int ts, int quad,
                                              Part&& part) {
  if constexpr (Q != kWalk) {
    part(quad, true);
  } else {
    const int subs = sub_tiles(ts);
    for (int sub = 0; sub < subs; ++sub) part(sub, sub == 0);
  }
}

// The backward kernels' write of one chunk's sums at Q = kWalk: sacc
// [NT][kAccStride] holds the current sub-tile's sums of the chunk's lanes;
// those of the window [lo, hi) go to grad [NT, s_total] at slot base +
// lane, written by the first sub-tile and added by the later ones.  A
// thread reads back only what it wrote itself for the earlier sub-tiles
// (the same i), so one barrier before (the sums are complete) suffices.
// Every thread of the block must call it.
template <int NT>
__device__ __forceinline__ void walk_write(const float* sacc,
                                           float* __restrict__ grad,
                                           long long s_total, long long base,
                                           int lo, int hi, bool first) {
  __syncthreads();
  for (int i = threadIdx.x; i < NT * kChunk; i += blockDim.x) {
    const int f = i / kChunk;
    const int l = i - f * kChunk;
    if (l < lo || l >= hi) continue;
    float* g = &grad[f * s_total + base + l];
    *g = first ? sacc[f * kAccStride + l] : *g + sacc[f * kAccStride + l];
  }
}

// Launches `kernel` over num_tiles tiles of side ts on stream s: with Q =
// 1 or kWalk one block a tile, as <<<>>> with no cluster attribute; with Q
// = kQuads kQuads blocks a tile, a cluster each (cudaLaunchKernelEx with
// cudaLaunchAttributeClusterDimension).  Returns the launch's error, else
// cudaGetLastError().
template <int Q, typename... Params, typename... Args>
cudaError_t launch_tiles(void (*kernel)(Params...), int num_tiles, int ts,
                         cudaStream_t s, Args... args) {
  if constexpr (Q != kQuads) {
    kernel<<<dim3(num_tiles), dim3(threads(ts)), 0, s>>>(args...);
    return cudaGetLastError();
  } else {
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(num_tiles * Q);
    config.blockDim = dim3(threads(ts));
    config.dynamicSmemBytes = 0;
    config.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = Q;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&config, kernel, args...);
    const cudaError_t last = cudaGetLastError();
    return err != cudaSuccess ? err : last;
  }
}

// launch(std::integral_constant<int, Q>{}) for the layout Q of a tile of
// side ts (layout()): the C entries' dispatch to their instantiations.
template <typename Launch>
cudaError_t by_layout(int ts, Launch&& launch) {
  switch (layout(ts)) {
    case 1:
      return launch(std::integral_constant<int, 1>{});
    case kQuads:
      return launch(std::integral_constant<int, kQuads>{});
    default:
      return launch(std::integral_constant<int, kWalk>{});
  }
}

// cudaOccupancyMaxActiveClusters of the kQuads-block instantiation
// `kernel` at 512 threads a block: how many of its clusters the card holds
// at once (0 if none fits).
template <typename... Params>
cudaError_t max_clusters(void (*kernel)(Params...), int* clusters) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kQuads);
  config.blockDim = dim3(threads(kMaxQuadTile));
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kQuads;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(
      clusters, reinterpret_cast<const void*>(kernel), &config);
}

}  // namespace warp_cull
