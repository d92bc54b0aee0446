// Tile compositor, backward (kernel B2 of the port) for sm_90a.
//
// Replaces the JAX package's Pallas kernel
// gaussiansplats3d_tpu/render/pallas_rasterize.py::_composite_bwd (body
// _bwd_one_tile).  The Python side, its checks and its plain PyTorch
// version (composite_bwd_torch) live in render/cuda_rasterize.py.
//
// One block per tile of side <= 32, of up to 512 threads, each holding 2
// pixels, B1's layout: a warp holds an 8 x 8 patch of the tile, lane l the
// pixels (l % 8, l / 8) and (l % 8, l / 8 + 4) of it (warp_cull::pixel),
// so a pair's box covers few warps and many of their lanes; pixels past
// the tile's edge are masked (has[q]).  A tile of side 33-64 is, as in B1,
// a thread-block cluster of 4 blocks of 512 threads, block r on the 32 x
// 32 quadrant (r % 2, r / 2) (warp_cull.cuh: the layout); every block
// replays the tile's chunks for its own pixels into its own sacc, and step
// 5 adds the four blocks' sums through distributed shared memory.  A tile
// of side 65 or more is one block of 512 threads that replays the tile's
// chunks for each of its 32 x 32 sub-tiles in turn (warp_cull.cuh: the
// walk), and step 5 adds each sub-tile's sums into the slots.  The layout
// is the template parameter Q (1, kQuads = 4 or kWalk), chosen by the
// side: the Q = 1 instantiation is the tile-32 kernel.  The tile's chunks
// are replayed in reverse, from exit_k - 1 down to 0: chunks at or past
// exit_k never ran forward and contribute nothing.  For each chunk:
//
// 1. the chunk's 128 records are staged in shared memory, and each warp
//    culls them against the rectangle of its pixels (warp_cull.cuh): a
//    128-bit mask of the pairs that may pass the box test at one of its
//    pixels.  Both passes below walk the mask's set bits only;
// 2. T at each pixel comes from B1's residual logt_after.  Where the
//    chunk's sum chunk_log of log(1 - alpha) is at least cs_floor, B1 set
//    logt_after = logt_before + chunk_log, so T_i = exp(logt_after -
//    rest_i), rest_i the sum over the pairs from i on, and the sweep's own
//    sum rebuilds logt_before.  Only where T fell below exp(cs_floor) in
//    the chunk is chunk_log clamped, and then logt_after <= cs_floor: a
//    warp with such a pixel (logt_after <= cs_floor + 1) first replays
//    B1's loop over the kept pairs in ascending order (both kernels
//    evaluate alpha with gauss_fragment.cuh, whose round-to-nearest
//    intrinsics nvcc cannot contract).  The pairs the cull drops are ones B1
//    skipped at these pixels, so that is B1's sequence of adds, and
//    logt_before = logt_after - max(chunk_log, cs_floor) undoes B1's
//    per-chunk accumulation;
// 3. the kept pairs are swept in descending order.  For pair i at a
//    pixel:
//      T_i     = exp(logt_before + chunk_log - rest_i)  (log space: never
//                                             divide by 1 - alpha, which
//                                             amplifies rounding 1000x at
//                                             0.999)
//      w       = alpha T_i,  cg = sum_c chan_c gchan_c + galpha
//      suffix  = sum of w_j cg_j over the pairs behind i (this chunk and
//                every later one)
//      d_alpha = T_i cg - suffix / max(1 - alpha, 1e-6), 0 unless
//                0 < alpha < 0.999
//      d_quad  = -alpha d_alpha / 2
//      d_mean  = -2 d_quad (a dx + b dy, b dx + c dy)
//      d_conic = d_quad (dx^2, 2 dx dy, dy^2)
//      d_chan  = w gchan,  d_opa = d_alpha exp(-g/2) (opa > 0)
// 4. a thread sums the NC + 6 terms over its pixels; a warp in which no
//    pixel passes the pair's cut-offs (box, g <= 8, min_alpha) skips the
//    pair; else the warp sums the terms at once with one reduce-scatter
//    (warp_cull::reduce_add) and its lanes add the totals into
//    sacc[NC + 6][128] in shared memory, one term a lane;
// 5. the window's slots of sacc are written to grad.  A slot lies in
//    exactly one tile's window, so the writes are exclusive: no global
//    atomics and no read-modify-write of chunks shared by two tiles (the
//    Pallas kernel's boundary-chunk RMW is a TPU mechanism).  Over a
//    cluster, block r adds lanes [32 r, 32 r + 32) of the four blocks'
//    sacc and writes those slots (warp_cull::cluster_write), between two
//    cluster barriers, so each slot is still written once.  In the walk
//    the first sub-tile writes the slots and each later one adds its sums
//    (warp_cull::walk_write): still no global atomics, since no other
//    block touches the slots.  The wrapper zero-fills grad; rx, ry and
//    slots outside the windows stay 0.
//
// What bounds it on the H100: arithmetic, not memory (records are read
// once per chunk): the cut-off tests and exp/log1p of the visits in the
// box, and the reductions of the pairs some pixel of a warp passes.  The
// cull leaves the box tests of the pairs whose box reaches the warp's
// patch; the replay runs only where T dies.
//
// Records are field-major [NC + 8, S] float32: x, y, conic a, b, c, the NC
// channels, opacity, rx, ry.  logt [T, P], exit_k [T] int32 are B1's
// residuals, gchans [T, NC + 1, P] the cotangent of B1's chans (row NC: the
// alpha row, a channel of value 1).  grad is [NC + 8, S] float32.

#include <cuda_runtime.h>

#include "gauss_fragment.cuh"
#include "warp_cull.cuh"

namespace {

using warp_cull::kAccStride;
using warp_cull::kChunk;
using warp_cull::kFull;
using warp_cull::kPix;                      // pixels a thread
constexpr int kThreads = 32 * 32 / kPix;   // enough for a 32 x 32 tile

// 2 blocks an SM: 64 registers a thread (PERF.md has ptxas's report); Q
// blocks a tile
template <int NC, int Q>
__global__ void __launch_bounds__(kThreads, 2)
composite_bwd_kernel(const float* __restrict__ rec, long long s_total,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts,
                     const int* __restrict__ ids,
                     const float* __restrict__ logt,
                     const int* __restrict__ exit_k,
                     const float* __restrict__ gchans, int ts, int tiles_x,
                     float min_alpha, float cs_floor,
                     float* __restrict__ grad) {
  constexpr int kFields = NC + 8;
  constexpr int kTerms = NC + 6;  // x, y, a, b, c, NC channels, opacity
  __shared__ float srec[kFields][kChunk];
  __shared__ float sacc[kTerms][kAccStride];

  int rank;
  const int tile = warp_cull::tile_of_block<Q>(rank);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int npix = ts * ts;
  const int start = starts[tile];
  const int count = counts[tile];
  const int id = ids[tile];
  const int start_chunk = start / kChunk;
  const float tx = static_cast<float>(id % tiles_x) * static_cast<float>(ts);
  const float ty = static_cast<float>(id / tiles_x) * static_cast<float>(ts);
  const int warp = tid >> 5;

  // The pixels of quadrant or sub-tile `quad` (warp_cull::walk_backward):
  // the tile's chunks from exit_k - 1 down to 0; at Q = kWalk the first
  // sub-tile writes each chunk's sums, the later ones add theirs.
  auto part = [&](int quad, [[maybe_unused]] bool first) {
    const warp_cull::Rect rect = warp_cull::rect<Q>(tx, ty, ts, warp, quad);
    const bool held = warp_cull::held<Q>(ts, quad, warp);
    // the term whose warp total the reduce-scatter leaves on this lane
    const int term_of_lane = warp_cull::reduced_term<kTerms>(lane);

    bool has[kPix];
    float px[kPix], py[kPix], lt_after[kPix];
    float sg[kPix];  // sum of w cg over every pair behind the current one
    float gch[kPix][NC + 1];
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      int ix, iy;
      warp_cull::pixel<Q>(ts, warp, q, lane, ix, iy, quad);
      has[q] = warp_cull::inside(ts, ix, iy);
      const int pp = has[q] ? iy * ts + ix : 0;
      // GL pixel centre, as B1 computes it
      px[q] = tx + static_cast<float>(ix) + 0.5f;
      py[q] = ty + static_cast<float>(iy) + 0.5f;
#pragma unroll
      for (int c = 0; c <= NC; ++c) {
        gch[q][c] = has[q]
            ? gchans[(static_cast<long long>(tile) * (NC + 1) + c) * npix + pp]
            : 0.0f;
      }
      lt_after[q] = has[q] ? logt[static_cast<long long>(tile) * npix + pp]
                           : 0.0f;
      sg[q] = 0.0f;
    }

    for (int k = exit_k[tile] - 1; k >= 0; --k) {
      const long long base = static_cast<long long>(start_chunk + k) * kChunk;
      __syncthreads();  // the previous chunk's records and sums are consumed
      for (int i = tid; i < kFields * kChunk; i += nthreads) {
        const int f = i / kChunk;
        const int l = i - f * kChunk;
        const long long slot = base + l;
        srec[f][l] = slot < s_total ? rec[f * s_total + slot] : 0.0f;
      }
      for (int i = tid; i < kTerms * kChunk; i += nthreads) {
        sacc[i / kChunk][i % kChunk] = 0.0f;
      }
      __syncthreads();
      const int lo = max(static_cast<int>(start - base), 0);
      const int hi = min(static_cast<int>(start + count - base), kChunk);
      warp_cull::Mask kept = warp_cull::cull(
          srec[0], srec[1], srec[NC + 6], srec[NC + 7], lo, hi, rect, lane);
      if (!held) kept = {};  // a patch past the tile's edge (Q != 1)

      // T before the pair being swept is exp(t_base - rest).  Where B1's
      // chunk sum is at least cs_floor, logt_before = logt_after - sum, so
      // t_base = logt_after and the sum need not be known before the sweep:
      // the sweep's own sum rebuilds logt_before after it.  Only a chunk in
      // which T falls below exp(cs_floor) has a sum under the floor, and
      // then logt_after <= cs_floor (logt_after = logt_before + max(sum,
      // cs_floor), logt_before <= 0; the margin of 1 covers the rounding of
      // the rebuilt logt_after).  A warp with such a pixel replays B1's loop
      // over the kept pairs, in ascending order, for every pixel: the pairs
      // the cull drops are ones B1 skipped at these pixels, so chunk_log is
      // B1's sequence of adds, its bits.
      bool dying = false;
#pragma unroll
      for (int q = 0; q < kPix; ++q) {
        dying |= has[q] && !(lt_after[q] > cs_floor + 1.0f);
      }
      const bool replay = __any_sync(kFull, dying);
      float t_base[kPix], lt_before[kPix], rest[kPix];
#pragma unroll
      for (int q = 0; q < kPix; ++q) {
        t_base[q] = lt_after[q];
        lt_before[q] = rest[q] = 0.0f;
      }
      if (replay) {
        float chunk_log[kPix];
#pragma unroll
        for (int q = 0; q < kPix; ++q) chunk_log[q] = 0.0f;
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
              chunk_log[q] += log1pf(-f.alpha);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < kPix; ++q) {
          lt_before[q] = lt_after[q] - fmaxf(chunk_log[q], cs_floor);
          t_base[q] = chunk_log[q] + lt_before[q];
        }
      }

      // Reverse sweep over the kept pairs.  Every lane runs every step (the
      // mask is the warp's), so the warp collectives see the whole warp.
#pragma unroll 1
      for (int j = warp_cull::kWords - 1; j >= 0; --j) {
        for (unsigned bits = warp_cull::word(kept, j); bits != 0;) {
          const int l = j * 32 + warp_cull::pop_highest(bits);
          const float ca = srec[2][l], cb = srec[3][l], cc = srec[4][l];
          const float opa = srec[NC + 5][l];
          float t[kTerms];
#pragma unroll
          for (int f = 0; f < kTerms; ++f) t[f] = 0.0f;
          bool any = false;
#pragma unroll
          for (int q = 0; q < kPix; ++q) {
            gauss::Fragment f;
            if (!has[q] || !gauss::fragment<NC>(&srec[0][l], px[q], py[q],
                                                min_alpha, f)) {
              continue;
            }
            any = true;
            const float dx = f.dx, dy = f.dy, alpha = f.alpha;
            rest[q] += log1pf(-alpha);
            const float t_i = expf(t_base[q] - rest[q]);
            const float w = alpha * t_i;
            float cg = gch[q][NC];
#pragma unroll
            for (int c = 0; c < NC; ++c) cg += srec[5 + c][l] * gch[q][c];
            float d_alpha = 0.0f;
            if (alpha > 0.0f && alpha < gauss::kAlphaClamp) {
              d_alpha = t_i * cg - sg[q] / fmaxf(1.0f - alpha, 1e-6f);
            }
            sg[q] += w * cg;
            const float d_quad = d_alpha * (-0.5f * alpha);
            t[0] += d_quad * -2.0f * (ca * dx + cb * dy);
            t[1] += d_quad * -2.0f * (cb * dx + cc * dy);
            t[2] += d_quad * dx * dx;
            t[3] += d_quad * 2.0f * dx * dy;
            t[4] += d_quad * dy * dy;
#pragma unroll
            for (int c = 0; c < NC; ++c) t[5 + c] += w * gch[q][c];
            t[5 + NC] += opa > 0.0f ? d_alpha * f.e : 0.0f;
          }
          if (!__any_sync(kFull, any)) continue;  // warp-uniform
          warp_cull::reduce_add(t, lane, term_of_lane, &sacc[0][0], l);
        }
      }
      if (!replay) {
#pragma unroll
        for (int q = 0; q < kPix; ++q) lt_before[q] = lt_after[q] - rest[q];
      }
      if constexpr (Q == 1) {
        __syncthreads();
        for (int i = tid; i < kTerms * kChunk; i += nthreads) {
          const int f = i / kChunk;
          const int l = i - f * kChunk;
          if (l >= lo && l < hi) grad[f * s_total + base + l] = sacc[f][l];
        }
      } else if constexpr (Q == warp_cull::kQuads) {
        warp_cull::cluster_write<kTerms>(&sacc[0][0], grad, s_total, base, lo,
                                         hi);
      } else {
        warp_cull::walk_write<kTerms>(&sacc[0][0], grad, s_total, base, lo, hi,
                                      first);
      }
#pragma unroll
      for (int q = 0; q < kPix; ++q) lt_after[q] = lt_before[q];
    }
  };
  warp_cull::walk_backward<Q>(ts, rank, part);
}

template <int Q>
cudaError_t launch(int nc, int num_tiles, int ts, cudaStream_t s,
                   const float* rec, long long s_total, const int* starts,
                   const int* counts, const int* ids, const float* logt,
                   const int* exit_k, const float* gchans, int tiles_x,
                   float min_alpha, float cs_floor, float* grad) {
  if (nc == 3) {
    return warp_cull::launch_tiles<Q>(
        composite_bwd_kernel<3, Q>, num_tiles, ts, s, rec, s_total, starts,
        counts, ids, logt, exit_k, gchans, ts, tiles_x, min_alpha, cs_floor,
        grad);
  }
  if (nc == 4) {
    return warp_cull::launch_tiles<Q>(
        composite_bwd_kernel<4, Q>, num_tiles, ts, s, rec, s_total, starts,
        counts, ids, logt, exit_k, gchans, ts, tiles_x, min_alpha, cs_floor,
        grad);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches B2 on `stream` over num_tiles tiles and returns the launch's
// error or cudaGetLastError() (0 when the launch was accepted).  grad must
// be zero-filled by the caller.
extern "C" int composite_bwd(const float* rec, long long s_total, int nc,
                             const int* starts, const int* counts,
                             const int* ids, const float* logt,
                             const int* exit_k, const float* gchans,
                             int num_tiles, int ts, int tiles_x,
                             float min_alpha, float cs_floor, float* grad,
                             void* stream) {
  if (ts < 1 || (nc != 3 && nc != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(warp_cull::by_layout(ts, [&](auto q) {
    return launch<decltype(q)::value>(nc, num_tiles, ts, s, rec, s_total,
                                      starts, counts, ids, logt, exit_k,
                                      gchans, tiles_x, min_alpha, cs_floor,
                                      grad);
  }));
}

// cudaOccupancyMaxActiveClusters of B2's cluster instantiation for nc
// channels (3 or 4) into *clusters; returns the CUDA error.
extern "C" int composite_bwd_max_clusters(int nc, int* clusters) {
  return static_cast<int>(
      nc == 3 ? warp_cull::max_clusters(
                    composite_bwd_kernel<3, warp_cull::kQuads>, clusters)
              : warp_cull::max_clusters(
                    composite_bwd_kernel<4, warp_cull::kQuads>, clusters));
}
