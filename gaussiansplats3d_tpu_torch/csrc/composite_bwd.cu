// Tile compositor, backward (kernel B2 of the port) for sm_90a.
//
// Replaces the JAX package's Pallas kernel
// gaussiansplats3d_tpu/render/pallas_rasterize.py::_composite_bwd (body
// _bwd_one_tile).  The Python side, its checks and its plain PyTorch
// version (composite_bwd_torch) live in render/cuda_rasterize.py.
//
// One block per tile, one thread per pixel (P = tile_size^2 <= 1024, a
// multiple of 32), as B1 (composite_fwd.cu).  The tile's chunks are
// replayed in reverse, from exit_k - 1 down to 0: chunks at or past exit_k
// never ran forward and contribute nothing.  For each chunk:
//
// 1. the chunk's 128 records are staged in shared memory;
// 2. every thread recomputes the chunk's log-transmittance sum chunk_log
//    with B1's own loop (same order, same tests, expf, log1pf, fminf), so
//    logt_before = logt_after - max(chunk_log, cs_floor) undoes B1's
//    per-chunk accumulation;
// 3. every thread sweeps the chunk backwards.  For pair i at its pixel,
//    with excl_i = chunk_log - (sum of log(1 - alpha_j), j >= i):
//      T_i     = exp(excl_i + logt_before)   (log space: never divide by
//                                             1 - alpha, which amplifies
//                                             rounding 1000x at 0.999)
//      w       = alpha T_i,  cg = sum_c chan_c gchan_c + galpha
//      suffix  = sum of w_j cg_j over the pairs behind i (this chunk and
//                every later one)
//      d_alpha = T_i cg - suffix / max(1 - alpha, 1e-6), 0 unless
//                0 < alpha < 0.999
//      d_quad  = -alpha d_alpha / 2
//      d_mean  = -2 d_quad (a dx + b dy, b dx + c dy)
//      d_conic = d_quad (dx^2, 2 dx dy, dy^2)
//      d_chan  = w gchan,  d_opa = d_alpha exp(-g/2) (opa > 0)
// 4. each of those NC + 6 terms is summed over the tile's pixels: over the
//    warp by shuffles, then across warps by shared-memory adds into
//    sacc[NC + 6][128].  A warp in which no pixel passes the pair's
//    cut-offs (box, g <= 8, min_alpha) skips the pair's reduction: its
//    terms are all 0 (__any_sync).
// 5. the window's slots of sacc are written to grad.  A slot lies in
//    exactly one tile's window, so the writes are exclusive: no global
//    atomics and no read-modify-write of chunks shared by two tiles (the
//    Pallas kernel's boundary-chunk RMW is a TPU mechanism).  The wrapper
//    zero-fills grad; rx, ry and slots outside the windows stay 0.
//
// What bounds it on the H100: as B1, the pair-pixel evaluations (twice: the
// chunk_log recompute and the sweep), plus the reductions of the pairs
// that pass the cut-offs; records are read once per chunk.  Arithmetic, not
// memory.  Making it fast is later work.
//
// Records are field-major [NC + 8, S] float32: x, y, conic a, b, c, the NC
// channels, opacity, rx, ry.  logt [T, P], exit_k [T] int32 are B1's
// residuals, gchans [T, NC + 1, P] the cotangent of B1's chans (row NC: the
// alpha row, a channel of value 1).  grad is [NC + 8, S] float32.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;
constexpr float kGaussianCutoff = 8.0f;
constexpr float kAlphaClamp = 0.999f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

template <int NC>
__global__ void __launch_bounds__(1024)
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
  __shared__ float sacc[kTerms][kChunk];

  const int tile = blockIdx.x;
  const int pix = threadIdx.x;
  const int npix = blockDim.x;
  const int lane = pix & 31;
  const int start = starts[tile];
  const int count = counts[tile];
  const int id = ids[tile];
  const int start_chunk = start / kChunk;
  const float px = static_cast<float>(id % tiles_x) * static_cast<float>(ts)
                   + static_cast<float>(pix % ts) + 0.5f;
  const float py = static_cast<float>(id / tiles_x) * static_cast<float>(ts)
                   + static_cast<float>(pix / ts) + 0.5f;

  const long long p = npix;
  float gch[NC + 1];
#pragma unroll
  for (int c = 0; c <= NC; ++c) {
    gch[c] = gchans[(static_cast<long long>(tile) * (NC + 1) + c) * p + pix];
  }
  float lt_after = logt[static_cast<long long>(tile) * p + pix];
  float sg = 0.0f;  // sum of w cg over every pair behind the current one

  for (int k = exit_k[tile] - 1; k >= 0; --k) {
    const long long base = static_cast<long long>(start_chunk + k) * kChunk;
    __syncthreads();  // the previous chunk's records and sums are consumed
    for (int i = pix; i < kFields * kChunk; i += npix) {
      const int f = i / kChunk;
      const int l = i - f * kChunk;
      const long long slot = base + l;
      srec[f][l] = slot < s_total ? rec[f * s_total + slot] : 0.0f;
    }
    for (int i = pix; i < kTerms * kChunk; i += npix) {
      sacc[i / kChunk][i % kChunk] = 0.0f;
    }
    __syncthreads();
    const int lo = max(static_cast<int>(start - base), 0);
    const int hi = min(static_cast<int>(start + count - base), kChunk);

    // B1's loop, verbatim: the same chunk_log bits.
    float chunk_log = 0.0f;
    for (int l = lo; l < hi; ++l) {
      const float dx = px - srec[0][l];
      const float dy = py - srec[1][l];
      if (fabsf(dx) > srec[NC + 6][l] || fabsf(dy) > srec[NC + 7][l]) continue;
      const float g = srec[2][l] * dx * dx + 2.0f * srec[3][l] * dx * dy
                      + srec[4][l] * dy * dy;
      if (g > kGaussianCutoff) continue;
      float alpha = srec[NC + 5][l] * expf(-0.5f * g);
      if (!(alpha >= min_alpha)) continue;
      alpha = fminf(alpha, kAlphaClamp);
      chunk_log += log1pf(-alpha);
    }
    const float lt_before = lt_after - fmaxf(chunk_log, cs_floor);

    // Reverse sweep.  Every lane runs every iteration (no early continue)
    // so the warp collectives below see the whole warp.
    float rest = 0.0f;  // sum of log(1 - alpha_j) for j >= l in the chunk
    for (int l = hi - 1; l >= lo; --l) {
      const float dx = px - srec[0][l];
      const float dy = py - srec[1][l];
      const float ca = srec[2][l], cb = srec[3][l], cc = srec[4][l];
      const float opa = srec[NC + 5][l];
      bool valid = fabsf(dx) <= srec[NC + 6][l] && fabsf(dy) <= srec[NC + 7][l];
      float g = 0.0f, e = 0.0f, alpha = 0.0f;
      if (valid) {
        g = ca * dx * dx + 2.0f * cb * dx * dy + cc * dy * dy;
        valid = g <= kGaussianCutoff;
      }
      if (valid) {
        e = expf(-0.5f * g);
        alpha = opa * e;
        valid = alpha >= min_alpha;
      }
      if (!__any_sync(0xffffffffu, valid)) continue;  // warp-uniform

      float t[kTerms];
#pragma unroll
      for (int f = 0; f < kTerms; ++f) t[f] = 0.0f;
      if (valid) {
        alpha = fminf(alpha, kAlphaClamp);
        rest += log1pf(-alpha);
        const float t_i = expf(chunk_log - rest + lt_before);
        const float w = alpha * t_i;
        float cg = gch[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) cg += srec[5 + c][l] * gch[c];
        float d_alpha = 0.0f;
        if (alpha > 0.0f && alpha < kAlphaClamp) {
          d_alpha = t_i * cg - sg / fmaxf(1.0f - alpha, 1e-6f);
        }
        sg += w * cg;
        const float d_quad = d_alpha * (-0.5f * alpha);
        t[0] = d_quad * -2.0f * (ca * dx + cb * dy);
        t[1] = d_quad * -2.0f * (cb * dx + cc * dy);
        t[2] = d_quad * dx * dx;
        t[3] = d_quad * 2.0f * dx * dy;
        t[4] = d_quad * dy * dy;
#pragma unroll
        for (int c = 0; c < NC; ++c) t[5 + c] = w * gch[c];
        t[5 + NC] = opa > 0.0f ? d_alpha * e : 0.0f;
      }
#pragma unroll
      for (int f = 0; f < kTerms; ++f) {
        const float v = warp_sum(t[f]);
        if (lane == 0 && v != 0.0f) atomicAdd(&sacc[f][l], v);
      }
    }
    __syncthreads();
    for (int i = pix; i < kTerms * kChunk; i += npix) {
      const int f = i / kChunk;
      const int l = i - f * kChunk;
      if (l >= lo && l < hi) grad[f * s_total + base + l] = sacc[f][l];
    }
    lt_after = lt_before;
  }
}

}  // namespace

// Launches B2 on `stream` over num_tiles tiles and returns
// cudaGetLastError() (0 when the launch was accepted).  grad must be
// zero-filled by the caller.
extern "C" int composite_bwd(const float* rec, long long s_total, int nc,
                             const int* starts, const int* counts,
                             const int* ids, const float* logt,
                             const int* exit_k, const float* gchans,
                             int num_tiles, int ts, int tiles_x,
                             float min_alpha, float cs_floor, float* grad,
                             void* stream) {
  if (num_tiles > 0) {
    const dim3 grid(num_tiles);
    const dim3 block(ts * ts);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (nc == 3) {
      composite_bwd_kernel<3><<<grid, block, 0, s>>>(
          rec, s_total, starts, counts, ids, logt, exit_k, gchans, ts,
          tiles_x, min_alpha, cs_floor, grad);
    } else if (nc == 4) {
      composite_bwd_kernel<4><<<grid, block, 0, s>>>(
          rec, s_total, starts, counts, ids, logt, exit_k, gchans, ts,
          tiles_x, min_alpha, cs_floor, grad);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
