// Surfel tile compositor, forward (kernel B3 of the port) for sm_90a.
//
// Replaces the JAX package's Pallas kernel
// gaussiansplats3d_tpu/render/pallas_surfel.py::_fwd (entry
// composite_surfel_tiles_pallas).  The Python side, its checks and its
// plain PyTorch version live in render/cuda_surfel.py.
//
// B1 (composite_fwd.cu) with the 2DGS ray-plane fragment
// (surfel_fragment.cuh) in place of the Gaussian one, in B1's layout: one
// block per tile of side <= 32, of up to 512 threads, each holding 2
// pixels, a warp on an 8 x 8 patch of the tile (warp_cull::pixel), pixels
// past the tile's edge masked, so B3 and B4 hold the same pixels; a tile
// of side 33-64 is a thread-block cluster of 4 blocks of 512 threads, one
// a 32 x 32 quadrant (warp_cull.cuh: the layout), whose exit vote is taken
// over the cluster (warp_cull::cluster_any); a tile of side 65 or more is
// one block that walks its 32 x 32 sub-tiles, as B1 does (warp_cull.cuh:
// the walk).  The layout is the template parameter Q (1, kQuads = 4 or
// kWalk), chosen by the side: the Q = 1 instantiation is the tile-32
// kernel.  The tile's depth-sorted window [start, start + count) is read
// in the Pallas kernel's floor-aligned 128-pair chunks: chunk k covers records
// [(start / 128 + k) * 128, +128), lanes outside the window are skipped.
// Each chunk is staged in shared memory one record field per thread
// (coalesced); each warp culls it against the rectangle of its pixels
// (warp_cull.cuh) and walks the kept pairs in ascending order, each lane
// evaluating the fragment at its two pixels one after the other and
// compositing front to back in float32:
//
//   w = alpha * excl * T,   excl *= 1 - alpha,   chunk_log += log1p(-alpha)
//
// (excl the product of 1 - alpha over the chunk's earlier pairs).  The
// cull drops only pairs that fail the box test at every pixel of the warp
// and the walk keeps the order, so chunk_log is the ascending sum B4
// replays bit for bit where T dies.  At the chunk boundary T *=
// exp(chunk_log) and log T += max(chunk_log, cs_floor).  The tile stops
// once no pixel it holds has T > exit_t (__syncthreads_or after the
// chunk; no warp stops early); exit_k counts the chunks composited.
//
// What bounds it on the H100: arithmetic, not memory (each record is read
// once per chunk): the box tests, and the fragment (a cross product, two
// divisions, an exp) and log1p of the visits in the box, and the wait at
// each chunk's vote for the warp with the most kept pairs.  The cull
// leaves the box tests of the pairs whose box reaches the warp's patch,
// one pair's fields, read from shared memory, serve two pixels, and the
// weight's running product spares an exp a visit.
//
// Records are field-major [NC + 14, S] float32 (surfel_fragment.cuh).
// Outputs: colors [T, P, NC] (the composited channels), logt [T, P],
// exit_k [T] int32, with p = iy * ts + ix.

#include <cuda_runtime.h>

#include "surfel_fragment.cuh"
#include "warp_cull.cuh"

namespace {

using surfel::kChunk;
using warp_cull::kPix;                     // pixels a thread
constexpr int kThreads = 32 * 32 / kPix;   // enough for a 32 x 32 tile

// 2 blocks an SM, as B4 (PERF.md has ptxas's report); Q blocks a tile
template <int NC, int Q>
__global__ void __launch_bounds__(kThreads, 2)
surfel_fwd_kernel(const float* __restrict__ rec, long long s_total,
                  const int* __restrict__ starts,
                  const int* __restrict__ counts,
                  const int* __restrict__ ids, int ts, int tiles_x,
                  float min_alpha, float cs_floor, float exit_t,
                  float* __restrict__ colors, float* __restrict__ logt,
                  int* __restrict__ exit_k) {
  constexpr int kFields = NC + 14;
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
  const float x0 = static_cast<float>(id % tiles_x) * static_cast<float>(ts);
  const float y0 = static_cast<float>(id / tiles_x) * static_cast<float>(ts);
  // The pixels of quadrant or sub-tile `quad` (warp_cull::walk_forward),
  // from chunk 0 until the vote stops them (at Q = kWalk not before chunk
  // kmin); writes their outputs, returns the chunks composited.
  auto part = [&](int quad, [[maybe_unused]] int kmin) {
    const warp_cull::Rect rect = warp_cull::rect<Q>(x0, y0, ts, warp, quad);
    const bool held = warp_cull::held<Q>(ts, quad, warp);

    bool has[kPix];
    float px[kPix], py[kPix];
    float acc[kPix][NC];
    float t[kPix], lt[kPix];
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      int ix, iy;
      warp_cull::pixel<Q>(ts, warp, q, lane, ix, iy, quad);
      has[q] = warp_cull::inside(ts, ix, iy);
      // GL pixel centre: y up, rows flipped at assembly.
      px[q] = x0 + static_cast<float>(ix) + 0.5f;
      py[q] = y0 + static_cast<float>(iy) + 0.5f;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[q][c] = 0.0f;
      t[q] = 1.0f;
      lt[q] = 0.0f;
    }
    // every block of the cluster has started before a vote writes to it
    warp_cull::cluster_start<Q>();

    int k = 0;
    while (k < num_chunks) {
      const long long base = static_cast<long long>(start_chunk + k) * kChunk;
      // every thread is done with the previous chunk: it has passed the vote
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
          srec[9], srec[10], srec[12 + NC], srec[13 + NC], lo, hi, rect, lane);
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
            surfel::Fragment f;
            if (!has[q] || !surfel::fragment<NC>(&srec[0][l], px[q], py[q],
                                                 min_alpha, f)) {
              continue;
            }
            const float w = f.alpha * (excl[q] * t[q]);
            excl[q] *= 1.0f - f.alpha;
            chunk_log[q] += log1pf(-f.alpha);
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[q][c] += w * srec[11 + c][l];
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
      // every thread reaches the vote; a pixel past the tile's edge has none
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
      const long long at = static_cast<long long>(tile) * p + iy * ts + ix;
#pragma unroll
      for (int c = 0; c < NC; ++c) colors[at * NC + c] = acc[q][c];
      logt[at] = lt[q];
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
                   float* colors, float* logt, int* exit_k) {
  if (nc == 3) {
    return warp_cull::launch_tiles<Q>(
        surfel_fwd_kernel<3, Q>, num_tiles, ts, s, rec, s_total, starts,
        counts, ids, ts, tiles_x, min_alpha, cs_floor, exit_t, colors, logt,
        exit_k);
  }
  if (nc == 4) {
    return warp_cull::launch_tiles<Q>(
        surfel_fwd_kernel<4, Q>, num_tiles, ts, s, rec, s_total, starts,
        counts, ids, ts, tiles_x, min_alpha, cs_floor, exit_t, colors, logt,
        exit_k);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches B3 on `stream` over num_tiles tiles and returns the launch's
// error or cudaGetLastError() (0 when the launch was accepted).
extern "C" int surfel_fwd(const float* rec, long long s_total, int nc,
                          const int* starts, const int* counts,
                          const int* ids, int num_tiles, int ts, int tiles_x,
                          float min_alpha, float cs_floor, float exit_t,
                          float* colors, float* logt, int* exit_k,
                          void* stream) {
  if (ts < 1 || (nc != 3 && nc != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(warp_cull::by_layout(ts, [&](auto q) {
    return launch<decltype(q)::value>(nc, num_tiles, ts, s, rec, s_total,
                                      starts, counts, ids, tiles_x, min_alpha,
                                      cs_floor, exit_t, colors, logt, exit_k);
  }));
}

// cudaOccupancyMaxActiveClusters of B3's cluster instantiation for nc
// channels (3 or 4) into *clusters; returns the CUDA error.
extern "C" int surfel_fwd_max_clusters(int nc, int* clusters) {
  return static_cast<int>(
      nc == 3 ? warp_cull::max_clusters(
                    surfel_fwd_kernel<3, warp_cull::kQuads>, clusters)
              : warp_cull::max_clusters(
                    surfel_fwd_kernel<4, warp_cull::kQuads>, clusters));
}
