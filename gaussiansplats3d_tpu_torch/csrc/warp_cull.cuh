// Per-warp pair cull and pixel layout, shared by the compositors B1-B4 of
// the port (composite_fwd.cu, composite_bwd.cu, surfel_fwd.cu,
// surfel_bwd.cu) and the ablation bench B5 (kernel_bench.cu), and the
// per-pair warp reduction of the backward ones (B2, B4).
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

#include <cuda_runtime.h>

namespace warp_cull {

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

// warps that cover a ts x ts tile
__host__ __device__ inline int warps(int ts) {
  const int across = (ts + kPatch - 1) / kPatch;
  return across * across;
}

// column and row in the tile of pixel q of `lane` in warp `warp`
__device__ __forceinline__ void pixel(int ts, int warp, int q, int lane,
                                      int& ix, int& iy) {
  const int across = (ts + kPatch - 1) / kPatch;
  ix = warp % across * kPatch + lane % kPatch;
  iy = warp / across * kPatch + q * kPatchRowsPerQ + lane / kPatch;
}

__device__ __forceinline__ bool inside(int ts, int ix, int iy) {
  return ix < ts && iy < ts;
}

// the rectangle of the pixel centres of warp `warp`'s patch, clipped to
// the tile, in a tile whose corner is at (tx, ty)
__device__ __forceinline__ Rect rect(float tx, float ty, int ts, int warp) {
  const int across = (ts + kPatch - 1) / kPatch;
  const int c0 = warp % across * kPatch;
  const int r0 = warp / across * kPatch;
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

}  // namespace warp_cull
