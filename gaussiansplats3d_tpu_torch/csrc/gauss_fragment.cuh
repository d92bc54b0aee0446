// The 3DGS Gaussian fragment at one pixel, shared by kernels B1
// (composite_fwd.cu), B2 (composite_bwd.cu, both passes) and B5
// (kernel_bench.cu, the ablation bench on B1's layout) of the port.
//
// The arithmetic of the JAX package's pallas_rasterize.py::_composite_fwd
// (and of the plain version, cuda_rasterize._chunk_pairs):
//
//   dx = px - x,  dy = py - y
//   g = a dx^2 + 2 b dx dy + c dy^2,  e = exp(-g / 2),  alpha = opa e
//   alpha = min(alpha, 0.999)
//
// culled (the function returns false) outside the rx/ry box, where g > 8
// or where opa e < min_alpha (and where any of them is NaN).  The box test
// comes first: it is cheap and rejects most visits.
//
// Every product and sum that leads to alpha is written with
// round-to-nearest intrinsics, so nvcc contracts none of them into an FMA:
// B2 replays each chunk's sum of log(1 - alpha) where T dies and must get
// B1's bits, whatever code surrounds the call in either file.  It also
// makes g the plain version's (CPU float32, no FMA) bit for bit, and alpha
// up to expf's last bits.
//
// Records are field-major [NC + 8, S]: rows 0-1 x, y, 2-4 conic a, b, c,
// 5.. the NC channels, 5 + NC opacity, 6 + NC rx, 7 + NC ry.  `r` points
// at one pair's row-0 entry of a [NC + 8][kChunk] shared-memory chunk, so
// field f is r[f * kChunk].

#pragma once

#include <cuda_runtime.h>

namespace gauss {

constexpr int kChunk = 128;
constexpr float kGaussianCutoff = 8.0f;
constexpr float kAlphaClamp = 0.999f;

struct Fragment {
  float dx, dy;   // pixel - centre
  float e;        // exp(-g / 2)
  float alpha;    // clamped to kAlphaClamp
};

template <int NC>
__device__ __forceinline__ bool fragment(const float* r, float px, float py,
                                         float min_alpha, Fragment& f) {
  f.dx = __fsub_rn(px, r[0]);
  f.dy = __fsub_rn(py, r[kChunk]);
  if (fabsf(f.dx) > r[(6 + NC) * kChunk] ||
      fabsf(f.dy) > r[(7 + NC) * kChunk]) {
    return false;
  }
  // (a dx) dx + ((2 b) dx) dy + (c dy) dy, left to right
  const float g = __fadd_rn(
      __fadd_rn(__fmul_rn(__fmul_rn(r[2 * kChunk], f.dx), f.dx),
                __fmul_rn(__fmul_rn(__fmul_rn(2.0f, r[3 * kChunk]), f.dx),
                          f.dy)),
      __fmul_rn(__fmul_rn(r[4 * kChunk], f.dy), f.dy));
  if (g > kGaussianCutoff) return false;
  f.e = expf(__fmul_rn(-0.5f, g));
  const float alpha = __fmul_rn(r[(5 + NC) * kChunk], f.e);
  if (!(alpha >= min_alpha)) return false;
  f.alpha = fminf(alpha, kAlphaClamp);
  return true;
}

}  // namespace gauss
