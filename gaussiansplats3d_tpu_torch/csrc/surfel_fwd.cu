// Surfel tile compositor, forward (kernel B3 of the port) for sm_90a.
//
// Replaces the JAX package's Pallas kernel
// gaussiansplats3d_tpu/render/pallas_surfel.py::_fwd (entry
// composite_surfel_tiles_pallas).  The Python side, its checks and its
// plain PyTorch version live in render/cuda_surfel.py.
//
// B1 (composite_fwd.cu) with the 2DGS ray-plane fragment
// (surfel_fragment.cuh) in place of the Gaussian one.  One block per tile,
// one thread per pixel (P = tile_size^2 <= 1024).  The tile's depth-sorted
// window [start, start + count) is read in the Pallas kernel's
// floor-aligned 128-pair chunks: chunk k covers records
// [(start / 128 + k) * 128, +128), lanes outside the window are skipped.
// Each chunk is staged in shared memory one record field per thread
// (coalesced), then every thread composites its own pixel front to back in
// float32:
//
//   w = alpha * exp(chunk_log) * T,   chunk_log += log1p(-alpha)
//
// At the chunk boundary T *= exp(chunk_log) and log T += max(chunk_log,
// cs_floor), the per-chunk clamp B4 replays.  The tile stops once no pixel
// has T > exit_t (__syncthreads_or); exit_k counts the chunks composited.
//
// What bounds it on the H100: every pair of a chunk is tested at every
// pixel of the tile until the exit, and the fragment (a cross product, a
// division, an exp) runs on the visits inside the box: arithmetic, not
// memory (each record is read once per chunk).  Simple first: fast later.
//
// Records are field-major [NC + 14, S] float32 (surfel_fragment.cuh).
// Outputs: colors [T, P, NC] (the composited channels), logt [T, P],
// exit_k [T] int32.

#include <cuda_runtime.h>

#include "surfel_fragment.cuh"

namespace {

using surfel::kChunk;

template <int NC>
__global__ void __launch_bounds__(1024)
surfel_fwd_kernel(const float* __restrict__ rec, long long s_total,
                  const int* __restrict__ starts,
                  const int* __restrict__ counts,
                  const int* __restrict__ ids, int ts, int tiles_x,
                  float min_alpha, float cs_floor, float exit_t,
                  float* __restrict__ colors, float* __restrict__ logt,
                  int* __restrict__ exit_k) {
  constexpr int kFields = NC + 14;
  __shared__ float srec[kFields][kChunk];

  const int tile = blockIdx.x;
  const int pix = threadIdx.x;
  const int npix = blockDim.x;
  const int start = starts[tile];
  const int count = counts[tile];
  const int id = ids[tile];
  const int start_chunk = start / kChunk;
  const int num_chunks = (start % kChunk + count + kChunk - 1) / kChunk;
  // GL pixel centre: y up, rows flipped at assembly.
  const float px = static_cast<float>(id % tiles_x) * static_cast<float>(ts)
                   + static_cast<float>(pix % ts) + 0.5f;
  const float py = static_cast<float>(id / tiles_x) * static_cast<float>(ts)
                   + static_cast<float>(pix / ts) + 0.5f;

  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.0f;
  float t = 1.0f;
  float lt = 0.0f;
  int k = 0;
  while (k < num_chunks) {
    const long long base = static_cast<long long>(start_chunk + k) * kChunk;
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = pix; i < kFields * kChunk; i += npix) {
      const int f = i / kChunk;
      const int l = i - f * kChunk;
      const long long slot = base + l;
      srec[f][l] = slot < s_total ? rec[f * s_total + slot] : 0.0f;
    }
    __syncthreads();
    const int lo = max(static_cast<int>(start - base), 0);
    const int hi = min(static_cast<int>(start + count - base), kChunk);
    float chunk_log = 0.0f;
    for (int l = lo; l < hi; ++l) {
      surfel::Fragment f;
      if (!surfel::fragment<NC>(&srec[0][l], px, py, min_alpha, f)) continue;
      const float w = f.alpha * (expf(chunk_log) * t);
      chunk_log += log1pf(-f.alpha);
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] += w * srec[11 + c][l];
    }
    t *= expf(chunk_log);
    lt += fmaxf(chunk_log, cs_floor);
    ++k;
    if (!__syncthreads_or(t > exit_t)) break;
  }

  const long long p = npix;
  const long long at = static_cast<long long>(tile) * p + pix;
#pragma unroll
  for (int c = 0; c < NC; ++c) colors[at * NC + c] = acc[c];
  logt[at] = lt;
  if (pix == 0) exit_k[tile] = k;
}

}  // namespace

// Launches B3 on `stream` over num_tiles tiles and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int surfel_fwd(const float* rec, long long s_total, int nc,
                          const int* starts, const int* counts,
                          const int* ids, int num_tiles, int ts, int tiles_x,
                          float min_alpha, float cs_floor, float exit_t,
                          float* colors, float* logt, int* exit_k,
                          void* stream) {
  if (num_tiles > 0) {
    const dim3 grid(num_tiles);
    const dim3 block(ts * ts);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (nc == 3) {
      surfel_fwd_kernel<3><<<grid, block, 0, s>>>(
          rec, s_total, starts, counts, ids, ts, tiles_x, min_alpha, cs_floor,
          exit_t, colors, logt, exit_k);
    } else if (nc == 4) {
      surfel_fwd_kernel<4><<<grid, block, 0, s>>>(
          rec, s_total, starts, counts, ids, ts, tiles_x, min_alpha, cs_floor,
          exit_t, colors, logt, exit_k);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
