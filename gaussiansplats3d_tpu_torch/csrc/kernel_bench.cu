// Compositor ablation bench (kernel B5 of the port) for sm_90a.
//
// Replaces the JAX package's Pallas kernel
// gaussiansplats3d_tpu/tools/kernel_bench.py::build_variant (body `kernel`,
// launched by `run`).  The Python side, its checks and its plain PyTorch
// version live in tools/kernel_bench.py.
//
// Each variant is a clone of the 3DGS tile compositor's forward with one
// piece removed; only the timings matter, several variants compute wrong
// colours on purpose.  The variant is a template parameter, so each one
// compiles without the pieces it removes.  Every variant runs on B1's
// layout (csrc/composite_fwd.cu), so that their differences split today's
// B1: one block per tile of side <= 32, of warp_cull::warps(ts) * 32 <=
// 512 threads, each holding 2 pixels of its warp's 8 x 8 patch
// (warp_cull::pixel; pixels past the tile's edge are not held and cast no
// vote), and for a side of 33-64 a thread-block cluster of 4 blocks of 512
// threads, one a 32 x 32 quadrant (warp_cull.cuh: the layout), whose vote
// is taken over the cluster (warp_cull::cluster_any), and for a side of 65
// or more one block that walks the tile's 32 x 32 sub-tiles, as B1 does
// (warp_cull.cuh: the walk; each variant's own vote points, so exit_k per
// variant is the whole tile's).  The layout is the template parameter Q
// (1, kQuads = 4 or kWalk), chosen by the side: the Q = 1 instantiation is
// the tile-32 kernel.  The tile's pair window [start,
// start + count) is read in floor-aligned 128-pair chunks; for each
// chunk:
//
// 1. the chunk is staged in shared memory one record field per thread
//    (coalesced), and each warp culls it against the rectangle of its
//    pixels (warp_cull::cull): the pairs that may pass the box test at one
//    of them;
// 2. the warp walks the kept pairs in ascending order, both pixels at
//    each pair, through B1's fragment (gauss_fragment.cuh: the box test,
//    g, the g > 8 and min_alpha cut-offs, the 0.999 clamp);
// 3. the tile votes (__syncthreads_or) whether any pixel it holds still
//    has T > exit_t; the vote is also the barrier that lets the next
//    chunk's staging overwrite this one.
//
// `full` (the reference of the others):
//   w = alpha * excl * T,  excl *= 1 - alpha   (exclusive product)
//   col += w * rgb
// and at the end of each chunk T = max(T * excl, exp(-80)).  That is B1
// less its log1p per visit (the log-T sum B2 replays) and its alpha
// channel.  The tile stops at k = num_chunks or once no pixel has T > 1e-4.
//
// The others: log_scan (the prefix in log space: w = alpha exp(cl) T,
// cl += log1p(-alpha), T = max(T exp(cl), exp(-80)); the TPU's mxu_scan_2/3
// computed it on the matrix unit in bf16 limbs), exit_every4 (the vote only
// when k % 4 == 0), no_exit (no vote: only k < num_chunks), no_scan
// (w = alpha T and T never updated, so no tile exits), no_matmul (col[c] +=
// w of the chunk's lane c, c < 3: no colour read or blend; a lane the warp
// culls fails the box test at all its pixels, so the plain version's in-box
// entries agree), dma_only (staging and the vote only, no cull and no walk:
// col += x of the staged chunk's lane 0 at every held pixel and channel,
// T stays 1), grid_only (zeros, T = 0, exit_k = num_chunks, no loop: the
// per-tile launch and prologue at B1's block size).  Where a chunk has no
// vote (exit_every4 off the multiples of 4, no_exit) a plain
// __syncthreads() stands in for it, or the next staging would race the
// walk; over a cluster, a cluster barrier, so that the blocks stay in step
// between votes and a vote's slots are never written while a slower block
// still reads the last vote's.
//
// Records are field-major [11, S] float32 (NC = 3): x, y, conic a, b, c,
// r, g, b, opacity, rx, ry.  Outputs: colors [T, P, 3], T itself (not
// log T) [T, P], exit_k [T] int32, with p = iy * ts + ix.
//
// What bounds it on the H100: as B1, arithmetic, not memory (each record
// is read once per chunk): the box tests and the exp of the visits in the
// box, and the wait at each chunk's vote for the warp with the most kept
// pairs.  The design takes B1's answers to that (the per-warp cull, one
// pair's fields read once for two pixels, the weight's running product,
// the tile's exit), so that each variant's time less `full`'s is the cost
// of one piece of today's B1.

#include <cuda_runtime.h>

#include "gauss_fragment.cuh"
#include "warp_cull.cuh"

namespace {

using gauss::kChunk;
using warp_cull::kPix;                     // pixels a thread
constexpr int kThreads = 32 * 32 / kPix;   // enough for a 32 x 32 tile
constexpr int kNC = 3;
constexpr int kFields = kNC + 8;

enum Variant {
  kFull = 0,
  kLogScan = 1,
  kExitEvery4 = 2,
  kNoExit = 3,
  kNoScan = 4,
  kNoMatmul = 5,
  kDmaOnly = 6,
  kGridOnly = 7,
};

// 2 blocks an SM, as B1 ((512, 3) computed wrong results with
// __syncthreads_or; PERF.md); Q blocks a tile
template <int V, int Q>
__global__ void __launch_bounds__(kThreads, 2)
variant_kernel(const float* __restrict__ rec, long long s_total,
               const int* __restrict__ starts,
               const int* __restrict__ counts,
               const int* __restrict__ ids, int ts, int tiles_x,
               float min_alpha, float t_floor, float exit_t,
               float* __restrict__ colors, float* __restrict__ t_out,
               int* __restrict__ exit_k) {
  __shared__ float srec[kFields][kChunk];

  int rank;
  const int tile = warp_cull::tile_of_block<Q>(rank);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int start = starts[tile];
  const int count = counts[tile];
  const int start_chunk = start / kChunk;
  const int num_chunks = (start % kChunk + count + kChunk - 1) / kChunk;
  const long long p = static_cast<long long>(ts) * ts;

  if (V == kGridOnly) {
    auto zero = [&](int quad, int) {
#pragma unroll
      for (int q = 0; q < kPix; ++q) {
        int ix, iy;
        warp_cull::pixel<Q>(ts, warp, q, lane, ix, iy, quad);
        if (!warp_cull::inside(ts, ix, iy)) continue;
        const long long out =
            static_cast<long long>(tile) * p + iy * ts + ix;
#pragma unroll
        for (int c = 0; c < kNC; ++c) colors[out * kNC + c] = 0.0f;
        t_out[out] = 0.0f;
      }
      return num_chunks;
    };
    warp_cull::walk_forward<Q>(ts, rank, zero);
    if (tid == 0 && rank == 0) exit_k[tile] = num_chunks;
    return;
  }

  const int id = ids[tile];
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
    float col[kPix][kNC];
    float t[kPix];
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      int ix, iy;
      warp_cull::pixel<Q>(ts, warp, q, lane, ix, iy, quad);
      has[q] = warp_cull::inside(ts, ix, iy);
      // GL pixel centre: y up, rows flipped at assembly.
      px[q] = tx + static_cast<float>(ix) + 0.5f;
      py[q] = ty + static_cast<float>(iy) + 0.5f;
#pragma unroll
      for (int c = 0; c < kNC; ++c) col[q][c] = 0.0f;
      t[q] = 1.0f;
    }
    // every block of the cluster has started before a vote writes to it
    warp_cull::cluster_start<Q>();

    int k = 0;
    while (k < num_chunks) {
      const long long base = static_cast<long long>(start_chunk + k) * kChunk;
      // every thread is done with the previous chunk: it has passed the vote
      // or the barrier that stands in for it
      for (int i = tid; i < kFields * kChunk; i += nthreads) {
        const int f = i / kChunk;
        const int l = i - f * kChunk;
        const long long slot = base + l;
        srec[f][l] = slot < s_total ? rec[f * s_total + slot] : 0.0f;
      }
      __syncthreads();
      ++k;
      bool alive = false;
      if (V == kDmaOnly) {
        // read after the barrier, so the staging is waited for and used
        const float v = srec[0][0];
#pragma unroll
        for (int q = 0; q < kPix; ++q) {
#pragma unroll
          for (int c = 0; c < kNC; ++c) col[q][c] += v;
          // T stays 1: the vote never stops the tile
          alive |= has[q] && t[q] > exit_t;
        }
      } else {
        const int lo = max(static_cast<int>(start - base), 0);
        const int hi = min(static_cast<int>(start + count - base), kChunk);
        warp_cull::Mask kept = warp_cull::cull(
            srec[0], srec[1], srec[kNC + 6], srec[kNC + 7], lo, hi, rect, lane);
        if (!held) kept = {};  // a patch past the tile's edge (Q != 1)

        // the product of 1 - alpha over the chunk's earlier pairs, or for
        // log_scan its log
        float excl[kPix];
#pragma unroll
        for (int q = 0; q < kPix; ++q) excl[q] = V == kLogScan ? 0.0f : 1.0f;
#pragma unroll 1
        for (int j = 0; j < warp_cull::kWords; ++j) {
          for (unsigned bits = warp_cull::word(kept, j); bits != 0;) {
            const int l = j * 32 + warp_cull::pop_lowest(bits);
#pragma unroll
            for (int q = 0; q < kPix; ++q) {
              gauss::Fragment f;
              if (!has[q] || !gauss::fragment<kNC>(&srec[0][l], px[q], py[q],
                                                   min_alpha, f)) {
                continue;
              }
              float w;
              if (V == kNoScan) {
                w = f.alpha * t[q];
              } else if (V == kLogScan) {
                w = f.alpha * (expf(excl[q]) * t[q]);
                excl[q] += log1pf(-f.alpha);
              } else {
                w = f.alpha * (excl[q] * t[q]);
                excl[q] *= 1.0f - f.alpha;
              }
              if (V == kNoMatmul) {
                // lane l's weight into channel l (l < 3), with constant
                // indices so col stays in registers
#pragma unroll
                for (int c = 0; c < kNC; ++c) {
                  if (l == c) col[q][c] += w;
                }
              } else {
#pragma unroll
                for (int c = 0; c < kNC; ++c) col[q][c] += w * srec[5 + c][l];
              }
            }
          }
        }
#pragma unroll
        for (int q = 0; q < kPix; ++q) {
          if (V == kLogScan) {
            t[q] = fmaxf(t[q] * expf(excl[q]), t_floor);
          } else if (V != kNoScan) {
            t[q] = fmaxf(t[q] * excl[q], t_floor);
          }
          alive |= has[q] && t[q] > exit_t;
        }
      }
      // The vote, block-uniform (every thread has the same k): a pixel past
      // the tile's edge has none.  Without it, a plain barrier (over a
      // cluster, a cluster barrier).
      if (V == kNoExit || (V == kExitEvery4 && k % 4 != 0)) {
        if constexpr (Q == warp_cull::kQuads) {
          warp_cull::cg::this_cluster().sync();
        } else {
          __syncthreads();
        }
      } else if constexpr (Q == 1) {
        if (!__syncthreads_or(alive)) break;
      } else if constexpr (Q == warp_cull::kQuads) {
        if (!warp_cull::cluster_any(alive, k)) break;
      } else {
        if (!__syncthreads_or(alive) && k >= kmin) break;
      }
    }

#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      if (!has[q]) continue;
      int ix, iy;
      warp_cull::pixel<Q>(ts, warp, q, lane, ix, iy, quad);
      const long long out = static_cast<long long>(tile) * p + iy * ts + ix;
#pragma unroll
      for (int c = 0; c < kNC; ++c) colors[out * kNC + c] = col[q][c];
      t_out[out] = t[q];
    }
    return k;
  };
  const int k = warp_cull::walk_forward<Q>(ts, rank, part);
  if (tid == 0 && rank == 0) exit_k[tile] = k;
}

template <int Q>
cudaError_t launch(int variant, int num_tiles, int ts, cudaStream_t s,
                   const float* rec, long long s_total, const int* starts,
                   const int* counts, const int* ids, int tiles_x,
                   float min_alpha, float t_floor, float exit_t,
                   float* colors, float* t_out, int* exit_k) {
#define B5_LAUNCH(V)                                                        \
  return warp_cull::launch_tiles<Q>(variant_kernel<V, Q>, num_tiles, ts, s, \
                                    rec, s_total, starts, counts, ids, ts,  \
                                    tiles_x, min_alpha, t_floor, exit_t,    \
                                    colors, t_out, exit_k)
  switch (variant) {
    case kFull: B5_LAUNCH(kFull);
    case kLogScan: B5_LAUNCH(kLogScan);
    case kExitEvery4: B5_LAUNCH(kExitEvery4);
    case kNoExit: B5_LAUNCH(kNoExit);
    case kNoScan: B5_LAUNCH(kNoScan);
    case kNoMatmul: B5_LAUNCH(kNoMatmul);
    case kDmaOnly: B5_LAUNCH(kDmaOnly);
    case kGridOnly: B5_LAUNCH(kGridOnly);
    default: return cudaErrorInvalidValue;
  }
#undef B5_LAUNCH
}

}  // namespace

// Launches variant `variant` (the Variant enum) of B5 on `stream` over
// num_tiles tiles and returns the launch's error or cudaGetLastError() (0
// when the launch was accepted).
extern "C" int kernel_bench_variant(int variant, const float* rec,
                                    long long s_total, const int* starts,
                                    const int* counts, const int* ids,
                                    int num_tiles, int ts, int tiles_x,
                                    float min_alpha, float t_floor,
                                    float exit_t, float* colors, float* t_out,
                                    int* exit_k, void* stream) {
  if (ts < 1 || variant < kFull || variant > kGridOnly) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(warp_cull::by_layout(ts, [&](auto q) {
    return launch<decltype(q)::value>(variant, num_tiles, ts, s, rec, s_total,
                                      starts, counts, ids, tiles_x, min_alpha,
                                      t_floor, exit_t, colors, t_out, exit_k);
  }));
}

// cudaOccupancyMaxActiveClusters of B5's cluster instantiation of `full`
// (variant must be 0: the variants share the layout) into *clusters;
// returns the CUDA error.
extern "C" int kernel_bench_max_clusters(int variant, int* clusters) {
  if (variant != kFull) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(warp_cull::max_clusters(
      variant_kernel<kFull, warp_cull::kQuads>, clusters));
}
