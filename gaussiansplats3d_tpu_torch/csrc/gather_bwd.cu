// The record gather's backward for sm_90a: the gradient of
// records = fields.index_select(1, src), src the source splat of each
// depth-sorted pair slot (render/binning.py::expand_sort).
//
// Counterpart of the JAX package's _expand_sort_bwd
// (gaussiansplats3d_tpu/render/binning.py), which is no Pallas kernel: one
// sort by the sorted slot ids aligns the pair cotangents to their source
// slots, and the static slot layout then reduces them, the lanes as [N]
// slices summed, the aux region as segment sums over the compact big-splat
// table.  It replaces the port's earlier scatter-add (index_add_), whose
// unused aux slots and pad slots all name splat 0, so millions of float
// atomics landed on one address and ran one after another.  The Python
// side, its checks and its plain PyTorch version (gather_bwd_torch) live
// in render/binning.py.
//
// The slot layout (S = lanes n + aux_cap + pad slots): lane k, slots
// [k n, (k + 1) n), slot k n + i names splat i; aux, [lanes n, + aux_cap),
// row r of the big-splat table owns the aux slots [offs[r], offs[r] +
// counts[r]) clipped to aux_cap, and names splat big[r], ascending in r;
// the aux slots from covered (the table's last end) on, and the pad slots,
// name splat 0 (the table then has rows to spare, so its last row is
// empty and names 0).  perm[j] is the slot at sorted position j.
//
// Two launches, no atomics, each output written once:
//
// 1. gather_unsort_kernel, over the sorted positions j (a fixed grid of at
//    most partial_rows blocks, each thread a fixed stride of positions):
//    reads perm[j] and the F cotangents of column j, both coalesced, and
//    writes them as the slot-major row aligned[perm[j]] (G float4, F <= 4
//    G, G even: a row is whole 32-byte sectors, so that no two scattered
//    rows share a sector) when the slot lies below lanes n + min(covered,
//    aux_cap).  A tail slot (unused aux or pad) is summed into the
//    thread's own partial instead; the block sums its threads' partials
//    in a fixed tree into partials[block].  perm is a permutation, so every aligned row is
//    written once, whatever order the sort gave the ties.
// 2. gather_reduce_kernel, a thread a splat i: d[:, i] = the sum over the
//    lanes of aligned[k n + i] (a warp reads 32 neighbouring rows), plus,
//    for a splat of table row r = dest[i] < b_cap, the sum of its aux
//    segment's rows (contiguous): a segment of at most kSerialMax rows is
//    summed by its own lane, a longer one by the whole warp (lane l takes
//    rows l, l + 32, ..., then a shuffle tree), so a splat with thousands
//    of aux slots does not hold its warp for thousands of loads.  Warp 0
//    of block 0 adds the tail to splat 0: the partials of step 1, lane l
//    rows l, l + 32, ..., then a shuffle tree.
//
// Every sum runs in an order the grid and the layout fix, so two calls on
// the same inputs give the same bits.
//
// What bounds it on the H100: bytes.  The work is additions, about one a
// byte read; the least traffic reads the cotangents, perm and the table
// once and writes d once.  Step 1 also writes the aligned rows at random
// (a 64-byte row for F = 11: two whole sectors) and step 2 reads them back
// coalesced, about twice the least traffic again, in exchange for reading
// each cotangent once at full width instead of F random 4-byte reads a
// slot.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the longest aux segment one lane sums alone
constexpr long long kSerialMax = 16;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  // a fixed tree: the total lands on lane 0
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(kFull, v, off);
  }
  return v;
}

template <int G>
__device__ __forceinline__ void add_row(float (&acc)[4 * G],
                                        const float4* __restrict__ row) {
#pragma unroll
  for (int c = 0; c < G; ++c) {
    const float4 x = row[c];
    acc[4 * c] += x.x;
    acc[4 * c + 1] += x.y;
    acc[4 * c + 2] += x.z;
    acc[4 * c + 3] += x.w;
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
gather_unsort_kernel(const float* __restrict__ g, int f, long long s_total,
                     const long long* __restrict__ perm, long long body,
                     long long aux_cap, long long pad,
                     const long long* __restrict__ covered,
                     float4* __restrict__ aligned,
                     float* __restrict__ partials,
                     long long* __restrict__ tail_slots) {
  constexpr int R = 4 * G;
  __shared__ float sums[kWarps][R];
  const long long kept = covered ? min(*covered, aux_cap) : 0;
  const long long keep_end = body + kept;
  float acc[R];
#pragma unroll
  for (int q = 0; q < R; ++q) acc[q] = 0.0f;

  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       j < s_total; j += stride) {
    const long long s = perm[j];
    float v[R];
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] = q < f ? g[q * s_total + j] : 0.0f;
    if (s < keep_end) {
      float4* row = aligned + s * G;
#pragma unroll
      for (int c = 0; c < G; ++c) {
        row[c] = make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2],
                             v[4 * c + 3]);
      }
    } else {
#pragma unroll
      for (int q = 0; q < R; ++q) acc[q] += v[q];
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const float w = warp_sum(acc[q]);
    if (lane == 0) sums[warp][q] = w;
  }
  __syncthreads();
  if (threadIdx.x < R) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += sums[w][threadIdx.x];
    partials[static_cast<long long>(blockIdx.x) * R + threadIdx.x] = t;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *tail_slots = aux_cap - kept + pad;
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
gather_reduce_kernel(const float4* __restrict__ aligned, long long n,
                     int lanes, int f, long long aux_cap,
                     const long long* __restrict__ dest,
                     const long long* __restrict__ offs,
                     const long long* __restrict__ counts, long long b_cap,
                     const float* __restrict__ partials, int n_partials,
                     float* __restrict__ d) {
  constexpr int R = 4 * G;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool own = i < n;
  float acc[R];
#pragma unroll
  for (int q = 0; q < R; ++q) acc[q] = 0.0f;
  if (own) {
    for (int k = 0; k < lanes; ++k) add_row<G>(acc, aligned + (k * n + i) * G);
  }

  if (dest != nullptr) {
    // this splat's aux segment [lo, hi), empty unless it has a table row
    long long lo = 0, hi = 0;
    if (own) {
      const long long r = dest[i];
      if (r < b_cap) {
        const long long o = offs[r];
        lo = min(o, aux_cap);
        hi = min(o + counts[r], aux_cap);
      }
    }
    const float4* aux = aligned + lanes * n * G;
    if (hi - lo <= kSerialMax) {
      for (long long t = lo; t < hi; ++t) add_row<G>(acc, aux + t * G);
    }
    unsigned long_segs = __ballot_sync(kFull, hi - lo > kSerialMax);
    while (long_segs) {
      const int src = __ffs(long_segs) - 1;
      long_segs &= long_segs - 1;
      const long long a = __shfl_sync(kFull, lo, src);
      const long long b = __shfl_sync(kFull, hi, src);
      float part[R];
#pragma unroll
      for (int q = 0; q < R; ++q) part[q] = 0.0f;
      for (long long t = a + lane; t < b; t += 32) {
        add_row<G>(part, aux + t * G);
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const float tot = __shfl_sync(kFull, warp_sum(part[q]), 0);
        if (lane == src) acc[q] += tot;
      }
    }
  }

  if (blockIdx.x == 0 && threadIdx.x < 32) {
    // the tail, onto splat 0
    float part[R];
#pragma unroll
    for (int q = 0; q < R; ++q) part[q] = 0.0f;
    for (int p = lane; p < n_partials; p += 32) {
#pragma unroll
      for (int q = 0; q < R; ++q) part[q] += partials[p * R + q];
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const float tot = warp_sum(part[q]);
      if (lane == 0) acc[q] += tot;
    }
  }

  if (own) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (q < f) d[q * n + i] = acc[q];
    }
  }
}

template <int G>
cudaError_t launch(const float* g, int f, long long s_total,
                   const long long* perm, long long n, int lanes,
                   long long aux_cap, long long pad, const long long* dest,
                   const long long* offs, const long long* counts,
                   long long b_cap, const long long* covered, float* aligned,
                   float* partials, int partial_rows, float* d,
                   long long* tail_slots, cudaStream_t stream) {
  // a block of step 1 for each kThreads positions, at most one a row of
  // partials
  const int n_partials = static_cast<int>(
      min((s_total + kThreads - 1) / kThreads,
          static_cast<long long>(partial_rows)));
  float4* rows = reinterpret_cast<float4*>(aligned);
  gather_unsort_kernel<G><<<n_partials, kThreads, 0, stream>>>(
      g, f, s_total, perm, lanes * n, aux_cap, pad, covered, rows, partials,
      tail_slots);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long blocks = (n + kThreads - 1) / kThreads;
  gather_reduce_kernel<G><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(rows, n, lanes, f, aux_cap, dest, offs,
                                      counts, b_cap, partials, n_partials, d);
  return cudaGetLastError();
}

}  // namespace

// The gradient d [f, n] of records = fields.index_select(1, src) for the
// cotangent g [f, s_total] (field-major float32, sorted order), from the
// sort's permutation perm [s_total] and the slot layout: n splats, lanes,
// aux_cap, pad; the big-splat table dest [n] (each splat's row, b_cap if
// none), offs and counts [b_cap], covered (a device scalar); dest, offs,
// counts and covered are null without an aux region.  Scratch: aligned
// [lanes n + aux_cap, width] float32 (width, the floats of a slot row, a
// multiple of 8 in [f, 32]: whole 32-byte sectors) and partials
// [partial_rows, width] (step 1 runs at most partial_rows blocks, one
// row of partial tail sums each).  tail_slots (a device scalar) receives
// how many slots fold into splat 0 by the tail.  Two launches on stream;
// returns the CUDA error of the first that fails, or of the second.
extern "C" int gather_bwd(const float* g, int f, int width,
                          long long s_total,
                          const long long* perm, long long n, int lanes,
                          long long aux_cap, long long pad,
                          const long long* dest, const long long* offs,
                          const long long* counts, long long b_cap,
                          const long long* covered, float* aligned,
                          float* partials, int partial_rows, float* d,
                          long long* tail_slots, void* stream) {
  if (f < 1 || width < f || width > 32 || width % 8 || n < 1 ||
      lanes < 1 || partial_rows < 1 ||
      s_total != lanes * n + aux_cap + pad ||
      ((dest == nullptr) != (covered == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (width / 4) {
#define GATHER_BWD_CASE(G)                                                  \
  case G:                                                                   \
    err = launch<G>(g, f, s_total, perm, n, lanes, aux_cap, pad, dest,      \
                    offs, counts, b_cap, covered, aligned, partials,        \
                    partial_rows, d, tail_slots, s);                        \
    break;
    GATHER_BWD_CASE(2)
    GATHER_BWD_CASE(4)
    GATHER_BWD_CASE(6)
    GATHER_BWD_CASE(8)
#undef GATHER_BWD_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
