// Native host-side scene ingest: multithreaded decoders for the splat
// container formats, exposed with a C ABI for ctypes.
//
// This is the framework's native-runtime counterpart to the reference's
// C++ components (src/worker/sorter.cpp was its only native
// code; its hot host-side decode loops live in JS at
// src/loaders/SplatBuffer.js and src/loaders/ply/INRIAV1PlyParser.js).
// The device builds move the per-frame sort on chip, so the remaining
// host-native hot path is bulk ingest/decompression of multi-GB scene
// files — implemented here with std::thread fan-out over splat ranges.
//
// Decode semantics mirror the Python loaders exactly (io/splat.py,
// io/ply.py, io/ksplat.py); outputs are the SplatData SoA arrays:
//   means[N,3] scales[N,3] quats[N,4](x,y,z,w) colors[N,4] sh[N,K,3].

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

unsigned hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? n : 4;
}

template <typename F>
void parallel_for(int64_t n, F&& fn) {
  unsigned nt = std::min<int64_t>(hw_threads(), std::max<int64_t>(1, n / 4096));
  if (nt <= 1) {
    fn(int64_t{0}, n);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(nt);
  int64_t chunk = (n + nt - 1) / nt;
  for (unsigned t = 0; t < nt; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([=, &fn] { fn(lo, hi); });
  }
  for (auto& th : ts) th.join();
}

inline float half_to_float(uint16_t h) {
  uint32_t sign = (h >> 15) & 1u;
  uint32_t exp = (h >> 10) & 0x1Fu;
  uint32_t man = h & 0x3FFu;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign << 31;
    } else {
      // subnormal: normalize
      int e = -1;
      do {
        ++e;
        man <<= 1;
      } while (!(man & 0x400u));
      man &= 0x3FFu;
      bits = (sign << 31) | ((127 - 15 - e) << 23) | (man << 13);
    }
  } else if (exp == 31) {
    bits = (sign << 31) | 0x7F800000u | (man << 13);
  } else {
    bits = (sign << 31) | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float out;
  std::memcpy(&out, &bits, 4);
  return out;
}

inline void normalize4(float* q) {
  float n = std::sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  if (n < 1e-12f) n = 1e-12f;
  for (int i = 0; i < 4; ++i) q[i] /= n;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// .splat: 32-byte rows (f32 xyz, f32 scale, u8 RGBA, u8 quat w,x,y,z)
// ---------------------------------------------------------------------------
int gs_parse_splat(const uint8_t* data, int64_t n_bytes, float* means,
                   float* scales, float* quats, float* colors) {
  if (n_bytes % 32 != 0) return -1;
  int64_t n = n_bytes / 32;
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* row = data + i * 32;
      std::memcpy(means + i * 3, row, 12);
      std::memcpy(scales + i * 3, row + 12, 12);
      for (int c = 0; c < 4; ++c)
        colors[i * 4 + c] = row[24 + c] / 255.0f;
      float q[4];  // file order w,x,y,z
      for (int c = 0; c < 4; ++c)
        q[c] = (static_cast<float>(row[28 + c]) - 128.0f) / 128.0f;
      normalize4(q);
      quats[i * 4 + 0] = q[1];
      quats[i * 4 + 1] = q[2];
      quats[i * 4 + 2] = q[3];
      quats[i * 4 + 3] = q[0];
    }
  });
  return static_cast<int>(n);
}

// ---------------------------------------------------------------------------
// INRIA V1 binary .ply vertex block.
//
// field_offsets: byte offsets within a vertex record for
//   [x, y, z, scale_0..2, rot_0..3, f_dc_0..2, opacity] (-1 when absent),
// then sh_offsets[3 * k_file] byte offsets for f_rest fields in
// channel-major file order.  All fields are f32 (the INRIA dialect).
// ---------------------------------------------------------------------------
int gs_parse_ply_inria_v1(const uint8_t* data, int64_t n, int64_t stride,
                          const int32_t* field_offsets,
                          const int32_t* sh_offsets, int32_t k_out,
                          int32_t coeffs_per_channel, float* means,
                          float* scales, float* quats, float* colors,
                          float* sh) {
  auto rd = [&](const uint8_t* row, int32_t off) {
    float v;
    std::memcpy(&v, row + off, 4);
    return v;
  };
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* row = data + i * stride;
      for (int c = 0; c < 3; ++c)
        means[i * 3 + c] = rd(row, field_offsets[c]);
      for (int c = 0; c < 3; ++c) {
        int32_t off = field_offsets[3 + c];
        scales[i * 3 + c] = off >= 0 ? std::exp(rd(row, off)) : 0.01f;
      }
      float q[4] = {1.f, 0.f, 0.f, 0.f};  // (w, x, y, z)
      if (field_offsets[6] >= 0) {
        for (int c = 0; c < 4; ++c) q[c] = rd(row, field_offsets[6 + c]);
        normalize4(q);
      }
      quats[i * 4 + 0] = q[1];
      quats[i * 4 + 1] = q[2];
      quats[i * 4 + 2] = q[3];
      quats[i * 4 + 3] = q[0];
      const float SH_C0 = 0.28209479177387814f;
      for (int c = 0; c < 3; ++c) {
        int32_t off = field_offsets[10 + c];
        float v = off >= 0 ? (0.5f + SH_C0 * rd(row, off)) : 0.0f;
        v = std::floor(std::max(0.0f, v) * 255.0f);
        colors[i * 4 + c] = std::min(255.0f, std::max(0.0f, v)) / 255.0f;
      }
      int32_t op_off = field_offsets[13];
      float op = 1.0f;
      if (op_off >= 0) {
        op = 1.0f / (1.0f + std::exp(-rd(row, op_off)));
        op = std::min(255.0f, std::max(0.0f, std::floor(op * 255.0f))) / 255.0f;
      }
      colors[i * 4 + 3] = op;
      for (int ch = 0; ch < (k_out ? 3 : 0); ++ch)
        for (int k = 0; k < k_out; ++k)
          sh[(i * k_out + k) * 3 + ch] =
              rd(row, sh_offsets[ch * coeffs_per_channel + k]);
    }
  });
  return static_cast<int>(n);
}

// ---------------------------------------------------------------------------
// .ksplat splat records (one section).  level: 0, 1 or 2.
// bucket_of[i]: bucket index per splat (levels >= 1); bucket_centers[B*3].
// ---------------------------------------------------------------------------
int gs_parse_ksplat_section(const uint8_t* data, int64_t n, int32_t level,
                            int32_t sh_degree, const int32_t* bucket_of,
                            const float* bucket_centers, float scale_factor,
                            int32_t scale_range, float min_sh, float max_sh,
                            float* means, float* scales, float* quats,
                            float* colors, float* sh) {
  int comp = sh_degree == 0 ? 0 : (sh_degree == 1 ? 9 : 24);
  int k_out = sh_degree == 0 ? 0 : (sh_degree == 1 ? 3 : 8);
  int64_t bps;
  if (level == 0)
    bps = 44 + 4 * comp;
  else
    bps = 24 + (level == 1 ? 2 : 1) * comp;

  parallel_for(n, [&](int64_t lo, int64_t hi) {
    std::vector<float> shflat(comp);
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* row = data + i * bps;
      float q[4];
      const uint8_t* color_src;
      if (level == 0) {
        std::memcpy(means + i * 3, row, 12);
        std::memcpy(scales + i * 3, row + 12, 12);
        std::memcpy(q, row + 24, 16);
        color_src = row + 40;
        if (comp)
          std::memcpy(shflat.data(), row + 44, comp * 4);
      } else {
        const uint16_t* u16 = reinterpret_cast<const uint16_t*>(row);
        const float* bc = bucket_centers + bucket_of[i] * 3;
        for (int c = 0; c < 3; ++c)
          means[i * 3 + c] =
              (static_cast<float>(u16[c]) - scale_range) * scale_factor +
              bc[c];
        for (int c = 0; c < 3; ++c)
          scales[i * 3 + c] = half_to_float(u16[3 + c]);
        for (int c = 0; c < 4; ++c) q[c] = half_to_float(u16[6 + c]);
        color_src = row + 20;
        if (comp) {
          if (level == 1) {
            const uint16_t* shh = reinterpret_cast<const uint16_t*>(row + 24);
            for (int c = 0; c < comp; ++c) shflat[c] = half_to_float(shh[c]);
          } else {
            float rng = max_sh - min_sh;
            for (int c = 0; c < comp; ++c)
              shflat[c] = row[24 + c] / 255.0f * rng + min_sh;
          }
        }
      }
      normalize4(q);  // file order (w, x, y, z)
      quats[i * 4 + 0] = q[1];
      quats[i * 4 + 1] = q[2];
      quats[i * 4 + 2] = q[3];
      quats[i * 4 + 3] = q[0];
      for (int c = 0; c < 4; ++c)
        colors[i * 4 + c] = color_src[c] / 255.0f;
      // channel-major bands -> [K, 3] coefficient-major
      if (k_out >= 3)
        for (int ch = 0; ch < 3; ++ch)
          for (int k = 0; k < 3; ++k)
            sh[(i * k_out + k) * 3 + ch] = shflat[ch * 3 + k];
      if (k_out >= 8)
        for (int ch = 0; ch < 3; ++ch)
          for (int k = 0; k < 5; ++k)
            sh[(i * k_out + 3 + k) * 3 + ch] = shflat[9 + ch * 5 + k];
    }
  });
  return static_cast<int>(n);
}

}  // extern "C"
