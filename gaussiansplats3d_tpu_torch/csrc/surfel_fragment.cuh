// The 2DGS surfel fragment at one pixel, shared by kernels B3
// (surfel_fwd.cu) and B4 (surfel_bwd.cu) of the port.
//
// The arithmetic of the JAX package's pallas_surfel.py::_surfel_chunk_alpha
// (and of the plain version, cuda_surfel.surfel_alpha): with T the
// row-major 3x3 homography whose columns are Tu, Tv, Tw,
//
//   k = px Tw - Tu,  l = py Tw - Tv,  p = k x l,  s = p.xy / p.z
//   rho3d = |s|^2,  rho2d = 2 |pix - center|^2,  rho = min(rho3d, rho2d)
//   depth = s . Tw.xy + Tw.z where rho3d wins, else Tw.z
//   alpha = min(opacity exp(-rho / 2), 0.99)
//
// culled (the function returns false) outside the rx/ry box, where
// |p.z| < 1e-12, depth < 0.2 or alpha < min_alpha.  The box test comes
// first: it is cheap and rejects most visits.
//
// Every product, sum and the division that lead to alpha are written with
// round-to-nearest intrinsics, so nvcc contracts none of them into an FMA:
// B4 replays each chunk's sum of log(1 - alpha) and must get B3's bits,
// whatever code surrounds the call.  It also makes alpha the plain
// version's (CPU float32, no FMA) up to expf's last bits.
//
// Records are field-major [NC + 14, S]: rows 0-8 T (t00 t01 t02 t10 ...),
// 9-10 center x/y, 11.. the NC channels, 11 + NC opacity, 12 + NC rx,
// 13 + NC ry.  `r` points at one pair's row-0 entry of a [NC + 14][kChunk]
// shared-memory chunk, so field f is r[f * kChunk].

#pragma once

#include <cuda_runtime.h>

namespace surfel {

constexpr int kChunk = 128;
constexpr float kAlphaMax = 0.99f;
constexpr float kNearN = 0.2f;

struct Fragment {
  float alpha, ea;          // alpha, exp(-rho / 2)
  float su, sv, p2;         // s and the cross product's z
  float k0, k1, k2, l0, l1, l2;
  float dx, dy;             // pixel - center
  bool use3d;               // rho3d <= rho2d
};

template <int NC>
__device__ __forceinline__ bool fragment(const float* r, float px, float py,
                                         float min_alpha, Fragment& f) {
  f.dx = __fsub_rn(px, r[9 * kChunk]);
  f.dy = __fsub_rn(py, r[10 * kChunk]);
  if (fabsf(f.dx) > r[(12 + NC) * kChunk] ||
      fabsf(f.dy) > r[(13 + NC) * kChunk]) {
    return false;
  }
  const float tw0 = r[2 * kChunk], tw1 = r[5 * kChunk], tw2 = r[8 * kChunk];
  f.k0 = __fsub_rn(__fmul_rn(px, tw0), r[0]);
  f.k1 = __fsub_rn(__fmul_rn(px, tw1), r[3 * kChunk]);
  f.k2 = __fsub_rn(__fmul_rn(px, tw2), r[6 * kChunk]);
  f.l0 = __fsub_rn(__fmul_rn(py, tw0), r[1 * kChunk]);
  f.l1 = __fsub_rn(__fmul_rn(py, tw1), r[4 * kChunk]);
  f.l2 = __fsub_rn(__fmul_rn(py, tw2), r[7 * kChunk]);
  const float p0 = __fsub_rn(__fmul_rn(f.k1, f.l2), __fmul_rn(f.k2, f.l1));
  const float p1 = __fsub_rn(__fmul_rn(f.k2, f.l0), __fmul_rn(f.k0, f.l2));
  f.p2 = __fsub_rn(__fmul_rn(f.k0, f.l1), __fmul_rn(f.k1, f.l0));
  if (fabsf(f.p2) < 1e-12f) return false;
  f.su = __fdiv_rn(p0, f.p2);
  f.sv = __fdiv_rn(p1, f.p2);
  const float rho3d = __fadd_rn(__fmul_rn(f.su, f.su), __fmul_rn(f.sv, f.sv));
  const float rho2d = __fmul_rn(
      2.0f, __fadd_rn(__fmul_rn(f.dx, f.dx), __fmul_rn(f.dy, f.dy)));
  f.use3d = rho3d <= rho2d;
  const float depth =
      f.use3d ? __fadd_rn(__fadd_rn(__fmul_rn(f.su, tw0), __fmul_rn(f.sv, tw1)),
                          tw2)
              : tw2;
  if (depth < kNearN) return false;
  f.ea = expf(__fmul_rn(-0.5f, f.use3d ? rho3d : rho2d));
  f.alpha = fminf(__fmul_rn(r[(11 + NC) * kChunk], f.ea), kAlphaMax);
  return !(f.alpha < min_alpha);
}

}  // namespace surfel
