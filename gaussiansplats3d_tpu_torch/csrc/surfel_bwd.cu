// Surfel tile compositor, backward (kernel B4 of the port) for sm_90a.
//
// Replaces the JAX package's Pallas kernel
// gaussiansplats3d_tpu/render/pallas_surfel.py::_bwd.  The Python side, its
// checks and its plain PyTorch version (composite_surfel_bwd_torch, whose
// fragment chain is torch.autograd's) live in render/cuda_surfel.py.
//
// B2 (composite_bwd.cu) with the surfel fragment and its hand-derived
// transpose.  One block per tile of side <= 32, of up to 512 threads, each
// holding 2 pixels, laid out as B2's: a warp holds an 8 x 8 patch of the
// tile (warp_cull::pixel); the block has as many warps as the tile needs,
// and the pixels past the tile's edge are masked (has[q]).  A tile of side
// 33-64 is, as in B2, a thread-block cluster of 4 blocks of 512 threads,
// one a 32 x 32 quadrant (warp_cull.cuh: the layout), each replaying the
// tile's chunks for its own pixels; step 5 adds the four blocks' sums
// through distributed shared memory.  A tile of side 65 or more is one
// block that replays the tile's chunks for each of its 32 x 32 sub-tiles
// in turn, as B2 does (warp_cull.cuh: the walk).  The layout is the
// template parameter Q (1, kQuads = 4 or kWalk), chosen by the side: the Q
// = 1 instantiation is the tile-32 kernel.  The tile's chunks are replayed
// in reverse, exit_k - 1 down to 0; for each chunk:
//
// 1. the chunk's 128 records are staged in shared memory, and each warp
//    culls them against the rectangle of its pixels (warp_cull.cuh): both
//    passes below walk the kept pairs only;
// 2. T at each pixel comes from B3's residual logt_after as in B2: where
//    the chunk's sum of log(1 - alpha) is at least cs_floor, T_i =
//    exp(logt_after - rest_i) (rest_i the sum over the pairs from i on)
//    and the sweep's own sum rebuilds logt_before.  A warp with a pixel
//    whose T may have fallen below exp(cs_floor) in the chunk (logt_after
//    <= cs_floor + 1) first replays B3's arithmetic (surfel::fragment,
//    log1pf) over the kept pairs in ascending order, for each pixel: the
//    pairs the cull drops are ones B3 skipped at these pixels, so
//    logt_before = logt_after - max(chunk_log, cs_floor) undoes B3's
//    accumulation bit for bit there;
// 3. the kept pairs are swept backwards.  For pair i at a pixel:
//      T_i     = exp(logt_before + chunk_log - rest_i),  w = alpha T_i
//      cg      = sum_c chan_c gcol_c
//      S       = sum of w_j cg_j over the pairs behind i
//      d_alpha = T_i cg - S / (1 - alpha) - glogt / (1 - alpha)  (1 - alpha
//                floored at 1e-6), 0 unless 0 < alpha < 0.99
//    then the transpose of the fragment (pallas_surfel.py:331-379):
//      d_opa = d_alpha ea,  d_rho = -d_alpha opa ea / 2, to rho3d or rho2d
//      rho2d: d_dx = 4 dx d_rho, d_dy = 4 dy d_rho
//      rho3d: d_su = 2 su d_rho, d_sv = 2 sv d_rho;  d_p = (d_su, d_sv,
//             -(su d_su + sv d_sv)) / p.z;  d_k = l x d_p, d_l = d_p x k
//      t_i0 = -d_k_i, t_i1 = -d_l_i, t_i2 = px d_k_i + py d_l_i (T row i),
//      center = -(d_dx, d_dy), chan_c = w gcol_c, opacity = d_opa;
// 4. a thread sums each pair's NC + 12 terms over its pixels; a warp in
//    which no pixel passes the pair's culls skips the pair (a ballot);
//    else the warp sums all the terms at once with one reduce-scatter
//    (warp_cull::reduce_add) and its lanes add the totals into
//    sacc[NC + 12][128] in shared memory, one term a lane;
// 5. the window's slots of sacc are written to grad: a slot lies in one
//    tile's window only, so the writes are exclusive (no global atomics).
//    Over a cluster, block r adds lanes [32 r, 32 r + 32) of the four
//    blocks' sacc and writes those slots (warp_cull::cluster_write), so
//    each slot is still written once; in the walk the first sub-tile
//    writes the slots and the later ones add their sums
//    (warp_cull::walk_write).  The wrapper zero-fills grad; rx, ry and
//    slots outside the windows or past exit_k stay 0.
//
// What bounds it on the H100: arithmetic, not memory.  The fragment and
// its transpose at the visits that pass the culls, and the reductions of
// the pairs some pixel of a warp passes; the cull leaves the box tests of
// the pairs whose box reaches the warp's patch, and the replay runs only
// where T dies.
//
// Inputs: records [NC + 14, S] (surfel_fragment.cuh), B3's residuals logt
// [T, P] and exit_k [T], the cotangents gcol [T, P, NC] and glogt [T, P].
// Output grad [NC + 14, S] float32.

#include <cuda_runtime.h>

#include "surfel_fragment.cuh"
#include "warp_cull.cuh"

namespace {

using surfel::kChunk;
using warp_cull::kAccStride;
using warp_cull::kFull;

constexpr int kMaxPix = warp_cull::kPix;   // pixels a thread
constexpr int kThreads = 32 * 32 / kMaxPix;

// 2 blocks an SM: 64 registers a thread (PERF.md has ptxas's report); Q
// blocks a tile
template <int NC, int Q>
__global__ void __launch_bounds__(kThreads, 2)
surfel_bwd_kernel(const float* __restrict__ rec, long long s_total,
                  const int* __restrict__ starts,
                  const int* __restrict__ counts,
                  const int* __restrict__ ids,
                  const float* __restrict__ logt,
                  const int* __restrict__ exit_k,
                  const float* __restrict__ gcol,
                  const float* __restrict__ glogt, int ts, int tiles_x,
                  float min_alpha, float cs_floor,
                  float* __restrict__ grad) {
  constexpr int kFields = NC + 14;
  constexpr int kTerms = NC + 12;  // T (9), center (2), NC channels, opacity
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
  const float x0 = static_cast<float>(id % tiles_x) * static_cast<float>(ts);
  const float y0 = static_cast<float>(id / tiles_x) * static_cast<float>(ts);
  const int warp = tid >> 5;

  // The pixels of quadrant or sub-tile `quad` (warp_cull::walk_backward):
  // the tile's chunks from exit_k - 1 down to 0; at Q = kWalk the first
  // sub-tile writes each chunk's sums, the later ones add theirs.
  auto part = [&](int quad, [[maybe_unused]] bool first) {
    const warp_cull::Rect rect = warp_cull::rect<Q>(x0, y0, ts, warp, quad);
    const bool held = warp_cull::held<Q>(ts, quad, warp);

    bool has[kMaxPix];
    float px[kMaxPix], py[kMaxPix], gl[kMaxPix], lt_after[kMaxPix];
    float sg[kMaxPix];  // sum of w cg over every pair behind the current one
    float gc[kMaxPix][NC];
#pragma unroll
    for (int q = 0; q < kMaxPix; ++q) {
      int ix, iy;
      warp_cull::pixel<Q>(ts, warp, q, lane, ix, iy, quad);
      has[q] = warp_cull::inside(ts, ix, iy);
      const int pp = has[q] ? iy * ts + ix : 0;
      // GL pixel centre, as B3 computes it
      px[q] = x0 + static_cast<float>(ix) + 0.5f;
      py[q] = y0 + static_cast<float>(iy) + 0.5f;
      const long long at = static_cast<long long>(tile) * npix + pp;
      gl[q] = has[q] ? glogt[at] : 0.0f;
      lt_after[q] = has[q] ? logt[at] : 0.0f;
      sg[q] = 0.0f;
#pragma unroll
      for (int c = 0; c < NC; ++c) gc[q][c] = has[q] ? gcol[at * NC + c] : 0.0f;
    }
    // the term whose warp total the reduce-scatter leaves on this lane
    const int term_of_lane = warp_cull::reduced_term<kTerms>(lane);

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
          srec[9], srec[10], srec[12 + NC], srec[13 + NC], lo, hi, rect, lane);
      if (!held) kept = {};  // a patch past the tile's edge (Q != 1)

      // T before the pair being swept is exp(t_base - rest), as in B2
      // (composite_bwd.cu): t_base = logt_after, and the sweep's own sum
      // rebuilds logt_before, unless a pixel of the warp may have had its T
      // fall below exp(cs_floor) in this chunk (logt_after <= cs_floor + 1).
      // Then the warp replays B3's loop over the kept pairs, in ascending
      // order, for each of its pixels: the same chunk_log bits.
      bool dying = false;
#pragma unroll
      for (int q = 0; q < kMaxPix; ++q) {
        dying |= has[q] && !(lt_after[q] > cs_floor + 1.0f);
      }
      const bool replay = __any_sync(kFull, dying);
      float t_base[kMaxPix], lt_before[kMaxPix], rest[kMaxPix];
#pragma unroll
      for (int q = 0; q < kMaxPix; ++q) {
        t_base[q] = lt_after[q];
        lt_before[q] = rest[q] = 0.0f;
      }
      if (replay) {
        float chunk_log[kMaxPix];
#pragma unroll
        for (int q = 0; q < kMaxPix; ++q) chunk_log[q] = 0.0f;
#pragma unroll 1
        for (int j = 0; j < warp_cull::kWords; ++j) {
          for (unsigned bits = warp_cull::word(kept, j); bits != 0;) {
            const int l = j * 32 + warp_cull::pop_lowest(bits);
#pragma unroll
            for (int q = 0; q < kMaxPix; ++q) {
              surfel::Fragment f;
              if (!has[q] || !surfel::fragment<NC>(&srec[0][l], px[q], py[q],
                                                   min_alpha, f)) {
                continue;
              }
              chunk_log[q] += log1pf(-f.alpha);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < kMaxPix; ++q) {
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
          float term[kTerms];
#pragma unroll
          for (int t = 0; t < kTerms; ++t) term[t] = 0.0f;
          bool any = false;
#pragma unroll
          for (int q = 0; q < kMaxPix; ++q) {
            surfel::Fragment f;
            if (!has[q] || !surfel::fragment<NC>(&srec[0][l], px[q], py[q],
                                                 min_alpha, f)) {
              continue;
            }
            any = true;
            rest[q] += log1pf(-f.alpha);
            const float t_i = expf(t_base[q] - rest[q]);
            const float w = f.alpha * t_i;
            float cg = 0.0f;
#pragma unroll
            for (int c = 0; c < NC; ++c) cg += srec[11 + c][l] * gc[q][c];
            float d_alpha = 0.0f;
            if (f.alpha > 0.0f && f.alpha < surfel::kAlphaMax) {
              const float one_minus = fmaxf(1.0f - f.alpha, 1e-6f);
              d_alpha = t_i * cg - sg[q] / one_minus - gl[q] / one_minus;
            }
            sg[q] += w * cg;

            // the fragment's transpose
            const float d_rho = d_alpha * srec[11 + NC][l] * f.ea * -0.5f;
            float d_su = 0.0f, d_sv = 0.0f, d_dx = 0.0f, d_dy = 0.0f;
            if (f.use3d) {
              d_su = 2.0f * f.su * d_rho;
              d_sv = 2.0f * f.sv * d_rho;
            } else {
              d_dx = 4.0f * f.dx * d_rho;
              d_dy = 4.0f * f.dy * d_rho;
            }
            const float inv_p2 = 1.0f / f.p2;
            const float d_p0 = d_su * inv_p2;
            const float d_p1 = d_sv * inv_p2;
            const float d_p2 = -(f.su * d_su + f.sv * d_sv) * inv_p2;
            const float d_k0 = f.l1 * d_p2 - f.l2 * d_p1;
            const float d_k1 = f.l2 * d_p0 - f.l0 * d_p2;
            const float d_k2 = f.l0 * d_p1 - f.l1 * d_p0;
            const float d_l0 = f.k2 * d_p1 - f.k1 * d_p2;
            const float d_l1 = f.k0 * d_p2 - f.k2 * d_p0;
            const float d_l2 = f.k1 * d_p0 - f.k0 * d_p1;
            term[0] -= d_k0;
            term[1] -= d_l0;
            term[2] += px[q] * d_k0 + py[q] * d_l0;
            term[3] -= d_k1;
            term[4] -= d_l1;
            term[5] += px[q] * d_k1 + py[q] * d_l1;
            term[6] -= d_k2;
            term[7] -= d_l2;
            term[8] += px[q] * d_k2 + py[q] * d_l2;
            term[9] -= d_dx;
            term[10] -= d_dy;
#pragma unroll
            for (int c = 0; c < NC; ++c) term[11 + c] += w * gc[q][c];
            term[11 + NC] += d_alpha * f.ea;
          }
          if (!__any_sync(kFull, any)) continue;  // warp-uniform
          warp_cull::reduce_add(term, lane, term_of_lane, &sacc[0][0], l);
        }
      }
      if (!replay) {
#pragma unroll
        for (int q = 0; q < kMaxPix; ++q) lt_before[q] = lt_after[q] - rest[q];
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
      for (int q = 0; q < kMaxPix; ++q) lt_after[q] = lt_before[q];
    }
  };
  warp_cull::walk_backward<Q>(ts, rank, part);
}

template <int Q>
cudaError_t launch(int nc, int num_tiles, int ts, cudaStream_t s,
                   const float* rec, long long s_total, const int* starts,
                   const int* counts, const int* ids, const float* logt,
                   const int* exit_k, const float* gcol, const float* glogt,
                   int tiles_x, float min_alpha, float cs_floor,
                   float* grad) {
  if (nc == 3) {
    return warp_cull::launch_tiles<Q>(
        surfel_bwd_kernel<3, Q>, num_tiles, ts, s, rec, s_total, starts,
        counts, ids, logt, exit_k, gcol, glogt, ts, tiles_x, min_alpha,
        cs_floor, grad);
  }
  if (nc == 4) {
    return warp_cull::launch_tiles<Q>(
        surfel_bwd_kernel<4, Q>, num_tiles, ts, s, rec, s_total, starts,
        counts, ids, logt, exit_k, gcol, glogt, ts, tiles_x, min_alpha,
        cs_floor, grad);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches B4 on `stream` over num_tiles tiles and returns the launch's
// error or cudaGetLastError() (0 when the launch was accepted).  grad must
// be zero-filled by the caller.
extern "C" int surfel_bwd(const float* rec, long long s_total, int nc,
                          const int* starts, const int* counts,
                          const int* ids, const float* logt,
                          const int* exit_k, const float* gcol,
                          const float* glogt, int num_tiles, int ts,
                          int tiles_x, float min_alpha, float cs_floor,
                          float* grad, void* stream) {
  if (ts < 1 || (nc != 3 && nc != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(warp_cull::by_layout(ts, [&](auto q) {
    return launch<decltype(q)::value>(nc, num_tiles, ts, s, rec, s_total,
                                      starts, counts, ids, logt, exit_k, gcol,
                                      glogt, tiles_x, min_alpha, cs_floor,
                                      grad);
  }));
}

// cudaOccupancyMaxActiveClusters of B4's cluster instantiation for nc
// channels (3 or 4) into *clusters; returns the CUDA error.
extern "C" int surfel_bwd_max_clusters(int nc, int* clusters) {
  return static_cast<int>(
      nc == 3 ? warp_cull::max_clusters(
                    surfel_bwd_kernel<3, warp_cull::kQuads>, clusters)
              : warp_cull::max_clusters(
                    surfel_bwd_kernel<4, warp_cull::kQuads>, clusters));
}
