// Compositor ablation bench (kernel B5 of the port) for sm_90a.
//
// Replaces the JAX package's Pallas kernel
// gaussiansplats3d_tpu/tools/kernel_bench.py::build_variant (body `kernel`,
// launched by `run`).  The Python side, its checks and its plain PyTorch
// version live in tools/kernel_bench.py.
//
// Each variant is a clone of the 3DGS tile compositor's forward as it
// stood when the bench was written, with one piece removed; only the
// timings matter, several variants compute wrong colours on purpose.  The
// variant is a template parameter, so each one compiles without the pieces
// it removes.  B1's layout (csrc/composite_fwd.cu): one block per tile, one
// thread per pixel (P = tile_size^2 <= 1024), each floor-aligned 128-pair
// chunk staged in shared memory one record field per thread, lanes outside
// the tile's [start, start + count) window skipped.
//
// `full` (the reference of the others):
//   alpha = opa * exp(-0.5 g),   g = a dx^2 + 2 b dx dy + c dy^2
//   alpha = 0 where g > 8, alpha < min_alpha or |dx| > rx or |dy| > ry
//   alpha = min(alpha, 0.999)
//   w     = alpha * excl * T,    excl *= 1 - alpha   (exclusive product)
//   col  += w * rgb
// and at the end of each chunk T = max(T * excl, exp(-80)).  No log-T sum
// and no per-chunk floor: that is B1's later design.  The tile stops at
// k = num_chunks or once no pixel has T > 1e-4, tested after each chunk.
//
// The others: log_scan (the prefix in log space: w = alpha exp(cl) T,
// cl += log1p(-alpha), T = max(T exp(cl), exp(-80)); the TPU's mxu_scan_2/3
// computed it on the matrix unit in bf16 limbs), exit_every4 (the max-T
// test only when k % 4 == 0), no_exit (only k < num_chunks), no_scan
// (w = alpha T and T never updated, so every chunk is walked), no_matmul
// (col[c] += w of the chunk's lane c, c < 3: no colour read or blend),
// dma_only (col += x of the staged chunk's lane 0 for every pixel and
// channel, T stays 1: the global-to-shared load alone), grid_only (zeros,
// T = 0, exit_k = num_chunks, no loop: the per-tile launch and prologue).
//
// Records are field-major [11, S] float32 (NC = 3): x, y, conic a, b, c,
// r, g, b, opacity, rx, ry.  Outputs: colors [T, P, 3], T itself (not
// log T) [T, P], exit_k [T] int32.
//
// What bounds it on the H100: as B1, the arithmetic of the pair-pixel
// evaluations (every thread walks every pair of every chunk until the
// exit); the records are read once per tile.  The design does nothing
// about that: it is a measuring tool, and each variant keeps B1's simple
// structure so that the differences between them are the pieces removed.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;
constexpr int kNC = 3;
constexpr int kFields = kNC + 8;
constexpr float kGaussianCutoff = 8.0f;
constexpr float kAlphaClamp = 0.999f;

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

template <int V>
__global__ void __launch_bounds__(1024)
variant_kernel(const float* __restrict__ rec, long long s_total,
               const int* __restrict__ starts,
               const int* __restrict__ counts,
               const int* __restrict__ ids, int ts, int tiles_x,
               float min_alpha, float t_floor, float exit_t,
               float* __restrict__ colors, float* __restrict__ t_out,
               int* __restrict__ exit_k) {
  __shared__ float srec[kFields][kChunk];

  const int tile = blockIdx.x;
  const int pix = threadIdx.x;
  const int npix = blockDim.x;
  const int start = starts[tile];
  const int count = counts[tile];
  const int start_chunk = start / kChunk;
  const int num_chunks = (start % kChunk + count + kChunk - 1) / kChunk;
  const long long out = static_cast<long long>(tile) * npix + pix;

  if (V == kGridOnly) {
#pragma unroll
    for (int c = 0; c < kNC; ++c) colors[out * kNC + c] = 0.0f;
    t_out[out] = 0.0f;
    if (pix == 0) exit_k[tile] = num_chunks;
    return;
  }

  const int id = ids[tile];
  // GL pixel centre: y up, rows flipped at assembly.
  const float px = static_cast<float>(id % tiles_x) * static_cast<float>(ts)
                   + static_cast<float>(pix % ts) + 0.5f;
  const float py = static_cast<float>(id / tiles_x) * static_cast<float>(ts)
                   + static_cast<float>(pix / ts) + 0.5f;

  float col[kNC];
#pragma unroll
  for (int c = 0; c < kNC; ++c) col[c] = 0.0f;
  float t = 1.0f;
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
    ++k;
    if (V == kDmaOnly) {
      const float v = srec[0][0];
#pragma unroll
      for (int c = 0; c < kNC; ++c) col[c] += v;
      // T stays 1: the exit test below never stops the tile
      if (!__syncthreads_or(t > exit_t)) break;
      continue;
    }
    const int lo = max(static_cast<int>(start - base), 0);
    const int hi = min(static_cast<int>(start + count - base), kChunk);
    // exclusive product of 1 - alpha, or for log_scan its log
    float excl = V == kLogScan ? 0.0f : 1.0f;
    for (int l = lo; l < hi; ++l) {
      const float dx = px - srec[0][l];
      const float dy = py - srec[1][l];
      if (fabsf(dx) > srec[kNC + 6][l] || fabsf(dy) > srec[kNC + 7][l]) {
        continue;
      }
      const float g = srec[2][l] * dx * dx + 2.0f * srec[3][l] * dx * dy
                      + srec[4][l] * dy * dy;
      if (g > kGaussianCutoff) continue;
      float alpha = srec[kNC + 5][l] * expf(-0.5f * g);
      if (!(alpha >= min_alpha)) continue;
      alpha = fminf(alpha, kAlphaClamp);
      float w;
      if (V == kNoScan) {
        w = alpha * t;
      } else if (V == kLogScan) {
        w = alpha * (expf(excl) * t);
        excl += log1pf(-alpha);
      } else {
        w = alpha * (excl * t);
        excl *= 1.0f - alpha;
      }
      if (V == kNoMatmul) {
        // lane l's weight into channel l (l < 3), with constant indices so
        // col stays in registers
#pragma unroll
        for (int c = 0; c < kNC; ++c) {
          if (l == c) col[c] += w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < kNC; ++c) col[c] += w * srec[5 + c][l];
      }
    }
    if (V == kLogScan) {
      t = fmaxf(t * expf(excl), t_floor);
    } else if (V != kNoScan) {
      t = fmaxf(t * excl, t_floor);
    }
    // The exit test before the next chunk, as B1 makes it (block-uniform:
    // every thread has the same k and sees the same vote).  At k = 0 it
    // would pass trivially (T = 1).
    if (V == kExitEvery4) {
      if (k % 4 == 0 && !__syncthreads_or(t > exit_t)) break;
    } else if (V != kNoExit) {
      if (!__syncthreads_or(t > exit_t)) break;
    }
  }

#pragma unroll
  for (int c = 0; c < kNC; ++c) colors[out * kNC + c] = col[c];
  t_out[out] = t;
  if (pix == 0) exit_k[tile] = k;
}

template <int V>
void launch(const dim3& grid, const dim3& block, cudaStream_t s,
            const float* rec, long long s_total, const int* starts,
            const int* counts, const int* ids, int ts, int tiles_x,
            float min_alpha, float t_floor, float exit_t, float* colors,
            float* t_out, int* exit_k) {
  variant_kernel<V><<<grid, block, 0, s>>>(
      rec, s_total, starts, counts, ids, ts, tiles_x, min_alpha, t_floor,
      exit_t, colors, t_out, exit_k);
}

}  // namespace

// Launches variant `variant` (the Variant enum) of B5 on `stream` over
// num_tiles tiles and returns cudaGetLastError() (0 when the launch was
// accepted).
extern "C" int kernel_bench_variant(int variant, const float* rec,
                                    long long s_total, const int* starts,
                                    const int* counts, const int* ids,
                                    int num_tiles, int ts, int tiles_x,
                                    float min_alpha, float t_floor,
                                    float exit_t, float* colors, float* t_out,
                                    int* exit_k, void* stream) {
  if (num_tiles > 0) {
    const dim3 grid(num_tiles);
    const dim3 block(ts * ts);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define B5_LAUNCH(V)                                                       \
  launch<V>(grid, block, s, rec, s_total, starts, counts, ids, ts, tiles_x, \
            min_alpha, t_floor, exit_t, colors, t_out, exit_k)
    switch (variant) {
      case kFull: B5_LAUNCH(kFull); break;
      case kLogScan: B5_LAUNCH(kLogScan); break;
      case kExitEvery4: B5_LAUNCH(kExitEvery4); break;
      case kNoExit: B5_LAUNCH(kNoExit); break;
      case kNoScan: B5_LAUNCH(kNoScan); break;
      case kNoMatmul: B5_LAUNCH(kNoMatmul); break;
      case kDmaOnly: B5_LAUNCH(kDmaOnly); break;
      case kGridOnly: B5_LAUNCH(kGridOnly); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef B5_LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}
