// Tile compositor, forward (kernel B1 of the port) for sm_90a.
//
// Replaces the JAX package's Pallas kernel
// gaussiansplats3d_tpu/render/pallas_rasterize.py::_composite_fwd
// (entry composite_tiles).  The Python side, its checks and its plain
// PyTorch version live in render/cuda_rasterize.py.
//
// One block per tile of side <= 32, of up to 512 threads, each holding 2
// pixels, laid out as B2's: a warp holds an 8 x 8 patch of the tile, lane
// l the pixels (l % 8, l / 8) and (l % 8, l / 8 + 4) of it
// (warp_cull::pixel); pixels past the tile's edge are not held.  A tile of
// side 33-64 is a thread-block cluster of 4 such blocks of 512 threads,
// block r on the 32 x 32 quadrant (r % 2, r / 2) (warp_cull.cuh: the
// layout), each staging, culling and walking every chunk for its own
// pixels as above; the tile's exit vote is taken over the cluster
// (warp_cull::cluster_any), so every block stops at the tile's exit_k.
// A tile of side 65 or more is one such block of 512 threads that walks
// the tile's 32 x 32 sub-tiles in order (warp_cull.cuh: the walk), each as
// a cluster block holds its quadrant, with the sub-tile's own vote from
// the tile's exit so far on; the sub-tiles that stopped before the tile's
// exit_k run again to it (warp_cull::walk_forward).  The layout is the
// template parameter Q (1, kQuads = 4 or kWalk), chosen by the side: the Q
// = 1 instantiation is the tile-32 kernel.  The tile's depth-sorted pair
// window [start, start + count) is read in the same floor-aligned
// 128-pair chunks as the Pallas kernel: chunk k of a tile covers records
// [(start / 128 + k) * 128, +128), and lanes outside the window are
// skipped.  For each chunk:
//
// 1. the chunk is staged in shared memory one record field per thread
//    (coalesced), and each warp culls it against the rectangle of its
//    pixels (warp_cull.cuh): a 128-bit mask of the pairs that may pass the
//    box test at one of its pixels;
// 2. the warp walks the kept pairs in ascending order, and each lane
//    composites both of its pixels front to back in float32 through each
//    pair (gauss_fragment.cuh; its fields are read from shared memory once
//    for the two):
//
//      alpha = min(opa exp(-g / 2), 0.999), culled outside the box, at
//              g > 8 or below min_alpha
//      w     = alpha * excl * T,   excl *= 1 - alpha,
//      chunk_log += log1p(-alpha)
//
//    with excl the product of 1 - alpha over the chunk's earlier pairs
//    and T the transmittance before the chunk.  The cull drops only pairs
//    that fail the box test at every pixel of the warp, and the walk keeps
//    the order, so each pixel's chunk_log is the same ascending sum as a
//    walk over the whole chunk: B2 replays it bit for bit where T dies;
// 3. at the chunk boundary T *= exp(chunk_log) and log T += max(chunk_log,
//    cs_floor), the per-chunk clamp the backward replay relies on.  The
//    tile stops once no pixel it holds has T > exit_t (__syncthreads_or
//    after the chunk; a warp whose pixels are all done composites on until
//    the tile stops, as the Pallas kernel does; over a cluster, once no
//    pixel of any of its blocks has), and exit_k records how many chunks
//    it composited, so exit_k and log T mean what they mean in the JAX
//    package.
//
// What bounds it on the H100: arithmetic, not memory (each record is read
// once per chunk): the box tests, and exp/log1p of the visits in the box,
// and the wait at each chunk's vote for the warp with the most kept
// pairs.  The cull leaves the box tests of the pairs whose box reaches the
// warp's patch (about a fifth of them at 2M splats, 1080p), one pair's
// fields serve two pixels, the weight's running product spares an exp a
// visit, and the whole tile stops at the exit.  At sides 33-64 each of a
// cluster's blocks reads each chunk itself (L2 serves three of the four
// reads), and the vote adds a cluster barrier a chunk.  Above 64 one block
// reads each chunk once a sub-tile pass, and the walk's second passes
// repeat the work of the sub-tiles that exited early: speed is not its
// aim, covering every side the JAX package renders is.
//
// Records are field-major [NC + 8, S] float32: x, y, conic a, b, c, the NC
// channels, opacity, rx, ry.  Outputs: chans [T, NC + 1, P] (row NC is the
// composited alpha, the sum of the weights), logt [T, P], exit_k [T] int32,
// with p = iy * ts + ix.

#include <cuda_runtime.h>

#include "gauss_fragment.cuh"
#include "warp_cull.cuh"

namespace {

using gauss::kChunk;
using warp_cull::kPix;                     // pixels a thread
constexpr int kThreads = 32 * 32 / kPix;   // enough for a 32 x 32 tile

// 2 blocks an SM, as B2 (PERF.md has ptxas's report); Q blocks a tile
template <int NC, int Q>
__global__ void __launch_bounds__(kThreads, 2)
composite_fwd_kernel(const float* __restrict__ rec, long long s_total,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts,
                     const int* __restrict__ ids, int ts, int tiles_x,
                     float min_alpha, float cs_floor, float exit_t,
                     float* __restrict__ chans, float* __restrict__ logt,
                     int* __restrict__ exit_k) {
  constexpr int kFields = NC + 8;
  __shared__ float srec[kFields][kChunk];

  int rank;
  const int tile = warp_cull::tile_of_block<Q>(rank);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int start = starts[tile];
  const int count = counts[tile];
  const int id = ids[tile];
  const int start_chunk = start / kChunk;
  const int num_chunks = (start % kChunk + count + kChunk - 1) / kChunk;
  const float tx = static_cast<float>(id % tiles_x) * static_cast<float>(ts);
  const float ty = static_cast<float>(id / tiles_x) * static_cast<float>(ts);

  // The pixels of quadrant or sub-tile `quad` (warp_cull::walk_forward),
  // from chunk 0 until the vote stops them (at Q = kWalk not before chunk
  // kmin); writes their outputs, returns the chunks composited.
  auto part = [&](int quad, [[maybe_unused]] int kmin) {
    const warp_cull::Rect rect = warp_cull::rect<Q>(tx, ty, ts, warp, quad);
    const bool held = warp_cull::held<Q>(ts, quad, warp);

    bool has[kPix];
    float px[kPix], py[kPix];
    float acc[kPix][NC + 1];
    float t[kPix], lt[kPix];
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      int ix, iy;
      warp_cull::pixel<Q>(ts, warp, q, lane, ix, iy, quad);
      has[q] = warp_cull::inside(ts, ix, iy);
      // GL pixel centre: y up, rows flipped at assembly.
      px[q] = tx + static_cast<float>(ix) + 0.5f;
      py[q] = ty + static_cast<float>(iy) + 0.5f;
#pragma unroll
      for (int c = 0; c <= NC; ++c) acc[q][c] = 0.0f;
      t[q] = 1.0f;
      lt[q] = 0.0f;
    }
    // every block of the cluster has started before a vote writes to it
    warp_cull::cluster_start<Q>();

    int k = 0;
    while (k < num_chunks) {
      const long long base = static_cast<long long>(start_chunk + k) * kChunk;
      // every thread is done with the previous chunk: it has passed the
      // vote
      for (int i = tid; i < kFields * kChunk; i += nthreads) {
        const int f = i / kChunk;
        const int l = i - f * kChunk;
        const long long slot = base + l;
        srec[f][l] = slot < s_total ? rec[f * s_total + slot] : 0.0f;
      }
      __syncthreads();
      const int lo = max(static_cast<int>(start - base), 0);
      const int hi = min(static_cast<int>(start + count - base), kChunk);
      warp_cull::Mask kept = warp_cull::cull(
          srec[0], srec[1], srec[NC + 6], srec[NC + 7], lo, hi, rect, lane);
      if (!held) kept = {};  // a patch past the tile's edge (Q != 1)

      // chunk_log: the sum of log(1 - alpha) over the chunk's pairs so far;
      // excl: the product of 1 - alpha over them, T inside the chunk
      float chunk_log[kPix], excl[kPix];
#pragma unroll
      for (int q = 0; q < kPix; ++q) {
        chunk_log[q] = 0.0f;
        excl[q] = 1.0f;
      }
#pragma unroll 1
      for (int j = 0; j < warp_cull::kWords; ++j) {
        for (unsigned bits = warp_cull::word(kept, j); bits != 0;) {
          const int l = j * 32 + warp_cull::pop_lowest(bits);
#pragma unroll
          for (int q = 0; q < kPix; ++q) {
            gauss::Fragment f;
            if (!has[q] || !gauss::fragment<NC>(&srec[0][l], px[q], py[q],
                                                min_alpha, f)) {
              continue;
            }
            const float w = f.alpha * (excl[q] * t[q]);
            excl[q] *= 1.0f - f.alpha;
            chunk_log[q] += log1pf(-f.alpha);
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[q][c] += w * srec[5 + c][l];
            acc[q][NC] += w;
          }
        }
      }
      bool alive = false;
#pragma unroll
      for (int q = 0; q < kPix; ++q) {
        t[q] *= expf(chunk_log[q]);
        lt[q] += fmaxf(chunk_log[q], cs_floor);
        alive |= has[q] && t[q] > exit_t;
      }
      ++k;
      // every thread reaches the vote; a pixel past the tile's edge has
      // none
      if constexpr (Q == 1) {
        if (!__syncthreads_or(alive)) break;
      } else if constexpr (Q == warp_cull::kQuads) {
        if (!warp_cull::cluster_any(alive, k)) break;
      } else {
        if (!__syncthreads_or(alive) && k >= kmin) break;
      }
    }

    const long long p = static_cast<long long>(ts) * ts;
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      if (!has[q]) continue;
      int ix, iy;
      warp_cull::pixel<Q>(ts, warp, q, lane, ix, iy, quad);
      const long long pp = iy * ts + ix;
#pragma unroll
      for (int c = 0; c <= NC; ++c) {
        chans[(static_cast<long long>(tile) * (NC + 1) + c) * p + pp] =
            acc[q][c];
      }
      logt[static_cast<long long>(tile) * p + pp] = lt[q];
    }
    return k;
  };
  const int k = warp_cull::walk_forward<Q>(ts, rank, part);
  if (tid == 0 && rank == 0) exit_k[tile] = k;
}

template <int Q>
cudaError_t launch(int nc, int num_tiles, int ts, cudaStream_t s,
                   const float* rec, long long s_total, const int* starts,
                   const int* counts, const int* ids, int tiles_x,
                   float min_alpha, float cs_floor, float exit_t,
                   float* chans, float* logt, int* exit_k) {
  if (nc == 3) {
    return warp_cull::launch_tiles<Q>(
        composite_fwd_kernel<3, Q>, num_tiles, ts, s, rec, s_total, starts,
        counts, ids, ts, tiles_x, min_alpha, cs_floor, exit_t, chans, logt,
        exit_k);
  }
  if (nc == 4) {
    return warp_cull::launch_tiles<Q>(
        composite_fwd_kernel<4, Q>, num_tiles, ts, s, rec, s_total, starts,
        counts, ids, ts, tiles_x, min_alpha, cs_floor, exit_t, chans, logt,
        exit_k);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches B1 on `stream` over num_tiles tiles and returns the launch's
// error or cudaGetLastError() (0 when the launch was accepted).
extern "C" int composite_fwd(const float* rec, long long s_total, int nc,
                             const int* starts, const int* counts,
                             const int* ids, int num_tiles, int ts,
                             int tiles_x, float min_alpha, float cs_floor,
                             float exit_t, float* chans, float* logt,
                             int* exit_k, void* stream) {
  if (ts < 1 || (nc != 3 && nc != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(warp_cull::by_layout(ts, [&](auto q) {
    return launch<decltype(q)::value>(nc, num_tiles, ts, s, rec, s_total,
                                      starts, counts, ids, tiles_x, min_alpha,
                                      cs_floor, exit_t, chans, logt, exit_k);
  }));
}

// cudaOccupancyMaxActiveClusters of B1's cluster instantiation for nc
// channels (3 or 4) into *clusters; returns the CUDA error.
extern "C" int composite_fwd_max_clusters(int nc, int* clusters) {
  return static_cast<int>(
      nc == 3 ? warp_cull::max_clusters(
                    composite_fwd_kernel<3, warp_cull::kQuads>, clusters)
              : warp_cull::max_clusters(
                    composite_fwd_kernel<4, warp_cull::kQuads>, clusters));
}
