""".ksplat format: reader + writer, compression levels 0/1/2 (counterpart of
the JAX package's ``io/ksplat.py``).  Each section's records decode
through the native decoder (``io/native.py``) where it loads, else in
numpy.

The sectioned binary layout follows the reference exactly so files are
interchangeable (all refs into the reference's src/loaders/SplatBuffer.js):

- 4096-byte main header (`parseHeader` :819-848): u8 version major/minor;
  u32[1] maxSectionCount, u32[2] sectionCount, u32[3] maxSplatCount,
  u32[4] splatCount; u16[10] compressionLevel; f32[6..8] sceneCenter;
  f32[9..10] min/max SH coefficient (8-bit compression range).
- 1024-byte section headers (:877-941): u32[0] splatCount, u32[1]
  maxSplatCount, u32[2] bucketSize, u32[3] bucketCount, f32[4]
  bucketBlockSize, u16[10] bucketStorageSizeBytes, u32[6]
  compressionScaleRange, u32[7] storageSizeBytes, u32[8] fullBucketCount,
  u32[9] partiallyFilledBucketCount, u16[20] sphericalHarmonicsDegree.
- Section data: [partial-bucket u32 lengths][bucket centers f32 x3]
  [splat records].
- Per-splat record (CompressionLevels table :108-163):
  level 0: f32 center x3, f32 scale x3, f32 rotation x4 (w, x, y, z),
           u8 RGBA, f32 SH (channel-major within band: 9 = deg-1 then
           15 = deg-2, see fillSphericalHarmonicsArray :551-734);
  level 1: u16 bucketed center x3, f16 scale x3, f16 rotation x4, u8 RGBA,
           f16 SH;
  level 2: like 1 but SH quantized to u8 in [minCoeff, maxCoeff].
- Bucketed positions (levels >= 1): 16-bit offsets from 256-splat spatial
  bucket centers, decode (v - range) * (halfBlock / range) + center
  (:232-239, compressPositionOffset :1069-1073).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import SPHERICAL_HARMONICS_8BIT_RANGE
from ..core.types import SplatData
from . import native
from ._arrays import host_arrays, to_splatdata

HEADER_BYTES = 4096
SECTION_HEADER_BYTES = 1024
BUCKET_STORAGE_BYTES = 12
DEFAULT_BLOCK_SIZE = 5.0
DEFAULT_BUCKET_SIZE = 256
SH_COMPONENTS = {0: 0, 1: 9, 2: 24}
SH_DEG_TO_K = {0: 0, 1: 3, 2: 8}
_SH_HALF_RANGE = SPHERICAL_HARMONICS_8BIT_RANGE / 2.0


def _bytes_per_splat(level: int, sh_degree: int) -> int:
    base = {0: 12 + 12 + 16 + 4, 1: 6 + 6 + 8 + 4, 2: 6 + 6 + 8 + 4}[level]
    sh_bytes = {0: 4, 1: 2, 2: 1}[level] * SH_COMPONENTS[sh_degree]
    return base + sh_bytes


@dataclasses.dataclass
class KSplatHeader:
    version: tuple
    max_section_count: int
    section_count: int
    max_splat_count: int
    splat_count: int
    compression_level: int
    scene_center: np.ndarray
    min_sh: float
    max_sh: float


def parse_ksplat_header(data: bytes) -> KSplatHeader:
    u8 = np.frombuffer(data, np.uint8, 32, 0)
    u32 = np.frombuffer(data, "<u4", 8, 0)
    u16 = np.frombuffer(data, "<u2", 16, 0)
    f32 = np.frombuffer(data, "<f4", 11, 0)
    min_sh = float(f32[9]) or -_SH_HALF_RANGE
    max_sh = float(f32[10]) or _SH_HALF_RANGE
    return KSplatHeader(
        version=(int(u8[0]), int(u8[1])),
        max_section_count=int(u32[1]),
        section_count=int(u32[2]),
        max_splat_count=int(u32[3]),
        splat_count=int(u32[4]),
        compression_level=int(u16[10]),
        scene_center=np.array(f32[6:9], np.float32),
        min_sh=min_sh, max_sh=max_sh,
    )


def _f16_to_f32(u16arr: np.ndarray) -> np.ndarray:
    return u16arr.astype("<u2").view(np.float16).astype(np.float32)


def _section_buckets(data, section_base, n, bucket_size, bucket_count,
                     full_buckets, partial_buckets):
    """(bucket centers [B, 3], the bucket of each of the first ``n``
    records) of a level >= 1 section: full buckets of ``bucket_size``,
    then the partial buckets' lengths, read from the section's head."""
    if partial_buckets:
        plens = np.frombuffer(data, "<u4", partial_buckets, section_base)
    else:
        plens = np.zeros((0,), np.uint32)
    centers = np.frombuffer(
        data, "<f4", bucket_count * 3,
        section_base + partial_buckets * 4).reshape(bucket_count, 3)
    lens = np.concatenate([np.full(full_buckets, bucket_size, np.int64),
                           plens.astype(np.int64)])
    return centers, np.repeat(np.arange(len(lens)), lens)[:n]


def _numpy_section(rows, n, level, sh_degree, header, centers, bucket_of,
                   sf, scale_range):
    """(means, scales, quats, colors, sh) of ``n`` records in numpy."""
    if level == 0:
        f = rows[:, :44].copy().view("<f4")
        means = f[:, 0:3].copy()
        scales = f[:, 3:6].copy()
        q_wxyz = f[:, 6:10]
        colors_u8 = rows[:, 40:44]
        sh_flat = rows[:, 44:].copy().view("<f4") \
            if sh_degree else np.zeros((n, 0), np.float32)
    else:
        c_u16 = rows[:, 0:6].copy().view("<u2").astype(np.float32)
        sr_u16 = rows[:, 6:20].copy().view("<u2")
        scales = _f16_to_f32(sr_u16[:, 0:3])
        q_wxyz = _f16_to_f32(sr_u16[:, 3:7])
        colors_u8 = rows[:, 20:24]
        # bucketed center decode
        means = ((c_u16 - scale_range) * sf
                 + centers[bucket_of]).astype(np.float32)
        if sh_degree:
            if level == 1:
                sh_flat = _f16_to_f32(rows[:, 24:].copy().view("<u2"))
            else:
                rng = header.max_sh - header.min_sh
                sh_flat = (rows[:, 24:24 + SH_COMPONENTS[sh_degree]]
                           .astype(np.float32) / 255.0 * rng
                           + header.min_sh)
        else:
            sh_flat = np.zeros((n, 0), np.float32)

    # channel-major per band -> [N, K, 3] coefficient-major
    k = SH_DEG_TO_K[sh_degree]
    sh = np.zeros((n, k, 3), np.float32)
    if k >= 3:
        band1 = sh_flat[:, 0:9].reshape(n, 3, 3)   # [n, rgb, coeff]
        sh[:, 0:3, :] = band1.transpose(0, 2, 1)
    if k >= 8:
        band2 = sh_flat[:, 9:24].reshape(n, 3, 5)
        sh[:, 3:8, :] = band2.transpose(0, 2, 1)

    qn = np.maximum(np.linalg.norm(q_wxyz, axis=1, keepdims=True), 1e-12)
    q_wxyz = q_wxyz / qn
    colors = colors_u8.astype(np.float32) / 255.0
    return means, scales, q_wxyz[:, [1, 2, 3, 0]], colors, sh


def parse_ksplat(data: bytes, max_bytes: int | None = None,
                 device="cuda") -> SplatData:
    """Decode a .ksplat buffer into SplatData (all sections concatenated).

    ``max_bytes`` decodes only the valid PREFIX of a partially-downloaded
    buffer: every splat whose record (and its section's bucket metadata)
    lies below the watermark is returned — the progressive-load contract of
    the reference (src/loaders/ksplat/KSplatLoader.js:119-180,
    SplatBuffer.updateLoadedCounts :1038-1048).
    """
    header = parse_ksplat_header(data)
    if header.version[0] > 0:
        raise ValueError(
            f"unsupported .ksplat major version {header.version[0]}")
    level = header.compression_level
    if level not in (0, 1, 2):
        raise ValueError(f"unsupported compression level {level}")
    watermark = len(data) if max_bytes is None else min(max_bytes, len(data))

    parts = []
    section_base = (HEADER_BYTES
                    + header.max_section_count * SECTION_HEADER_BYTES)
    if watermark < section_base:
        raise ValueError(".ksplat prefix does not cover the section headers")
    for s in range(header.max_section_count):
        sh_off = HEADER_BYTES + s * SECTION_HEADER_BYTES
        u32 = np.frombuffer(data, "<u4", 10, sh_off)
        u16 = np.frombuffer(data, "<u2", 21, sh_off)
        f32 = np.frombuffer(data, "<f4", 5, sh_off)
        max_splats = int(u32[1])
        bucket_size = int(u32[2])
        bucket_count = int(u32[3])
        block_size = float(f32[4])
        bucket_storage = int(u16[10])
        scale_range = int(u32[6]) or 32767
        full_buckets = int(u32[8])
        partial_buckets = int(u32[9])
        sh_degree = int(u16[20])
        bps = _bytes_per_splat(level, sh_degree)

        meta_bytes = partial_buckets * 4
        buckets_bytes = (bucket_storage * bucket_count + meta_bytes
                         if level >= 1 else 0)
        data_base = section_base + buckets_bytes
        n_full = max_splats
        # progressive watermark: only records fully below it are decodable
        # (bucket metadata precedes the records, so a byte prefix is valid)
        n = max(0, min(n_full, (watermark - data_base) // bps))

        if n > 0:
            rows = np.frombuffer(data, np.uint8, n * bps, data_base
                                 ).reshape(n, bps)
            if level >= 1:
                centers, bucket_of = _section_buckets(
                    data, section_base, n, bucket_size, bucket_count,
                    full_buckets, partial_buckets)
                sf = (block_size / 2.0) / scale_range
            else:
                centers = np.zeros((0, 3), np.float32)
                bucket_of, sf = np.zeros((0,), np.int64), 0.0
            decoded = native.parse_ksplat_section_native(
                rows, n, level, sh_degree, bucket_of, centers, sf,
                scale_range, header.min_sh, header.max_sh)
            if decoded is None:
                native.record_decode("ksplat", "numpy")
                decoded = _numpy_section(rows, n, level, sh_degree, header,
                                         centers, bucket_of, sf, scale_range)
            parts.append(decoded)

        storage = int(u32[7]) or (n_full * bps + buckets_bytes)
        section_base += storage

    if not parts:
        if max_bytes is not None:
            return SplatData.zeros(0, device=device)
        raise ValueError(".ksplat contains no splats")
    max_deg = max(p[4].shape[1] for p in parts)
    means = np.concatenate([p[0] for p in parts])
    scales = np.concatenate([p[1] for p in parts])
    quats = np.concatenate([p[2] for p in parts])
    colors = np.concatenate([p[3] for p in parts])
    shs = []
    for p in parts:
        sh = p[4]
        if sh.shape[1] < max_deg:
            sh = np.concatenate(
                [sh, np.zeros((sh.shape[0], max_deg - sh.shape[1], 3),
                              np.float32)], axis=1)
        shs.append(sh)
    sh = np.concatenate(shs)
    return to_splatdata(means, scales, quats, colors, sh, device)


def load_ksplat(path: str, device="cuda") -> SplatData:
    with open(path, "rb") as f:
        return parse_ksplat(f.read(), device=device)


def _to_f16_bits(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float16).view("<u2")


def _prep_section(splats: SplatData, minimum_alpha: float, max_deg: int):
    """Filter + convert one section's arrays to numpy (shared SH degree)."""
    means, scales, quats, colors, sh = host_arrays(
        splats.with_sh_degree(max_deg))
    if minimum_alpha > 0:
        keep = colors[:, 3] * 255.0 >= minimum_alpha
        means, scales, quats, colors, sh = (
            means[keep], scales[keep], quats[keep], colors[keep], sh[keep])
    return means, scales, quats, colors, sh


def _encode_section(arrs, level, sh_degree, block_size, bucket_size,
                    min_sh, max_sh):
    """Encode one section -> (header_fields dict, section bytes)."""
    means, scales, quats, colors, sh = arrs
    n = means.shape[0]
    k = sh.shape[1]
    comp = SH_COMPONENTS[sh_degree]
    sh_flat = np.zeros((n, comp), np.float32)
    if k >= 3:
        sh_flat[:, 0:9] = sh[:, 0:3, :].transpose(0, 2, 1).reshape(n, 9)
    if k >= 8:
        sh_flat[:, 9:24] = sh[:, 3:8, :].transpose(0, 2, 1).reshape(n, 15)

    bps = _bytes_per_splat(level, sh_degree)
    q_wxyz = quats[:, [3, 0, 1, 2]]
    qn = np.maximum(np.linalg.norm(q_wxyz, axis=1, keepdims=True), 1e-12)
    q_wxyz = q_wxyz / qn
    colors_u8 = np.clip(np.rint(colors * 255.0), 0, 255).astype(np.uint8)

    if level == 0:
        bucket_centers = np.zeros((0, 3), np.float32)
        full_buckets = 0
        partial_lens = np.zeros((0,), np.uint32)
        buckets_bytes = 0
        rows = np.zeros((n, bps), np.uint8)
        rows[:, 0:12] = means.astype("<f4").view(np.uint8)
        rows[:, 12:24] = scales.astype("<f4").view(np.uint8)
        rows[:, 24:40] = np.ascontiguousarray(
            q_wxyz.astype("<f4")).view(np.uint8)
        rows[:, 40:44] = colors_u8
        if comp:
            rows[:, 44:] = sh_flat.astype("<f4").view(np.uint8)
    else:
        # Spatial bucketing (computeBucketsForUncompressedSplatArray
        # :1328-1399): grid of block_size cells; cells fill into buckets of
        # `bucket_size`, remainders become partially-filled buckets.
        mn = means.min(axis=0) if n else np.zeros(3, np.float32)
        dims = (means.max(axis=0) - mn) if n else np.zeros(3, np.float32)
        y_blocks = max(1, int(np.ceil(dims[1] / block_size)))
        z_blocks = max(1, int(np.ceil(dims[2] / block_size)))
        blk = np.floor((means - mn) / block_size).astype(np.int64)
        cell = blk[:, 0] * (y_blocks * z_blocks) + blk[:, 1] * z_blocks \
            + blk[:, 2]
        order = np.argsort(cell, kind="stable")
        cell_sorted = cell[order]
        _, cell_starts, cell_counts = np.unique(
            cell_sorted, return_index=True, return_counts=True)
        full_list = []
        partial_list = []
        for cs, cc in zip(cell_starts, cell_counts):
            nfull = cc // bucket_size
            for b in range(nfull):
                full_list.append((cs + b * bucket_size, bucket_size))
            rem = cc - nfull * bucket_size
            if rem:
                partial_list.append((cs + nfull * bucket_size, rem))
        buckets = full_list + partial_list
        full_buckets = len(full_list)
        partial_lens = np.array([c for _, c in partial_list], np.uint32)
        bucket_order = np.concatenate(
            [order[st:st + c] for st, c in buckets]) if buckets else order
        order = bucket_order
        centers_cell = mn + (blk[order] + 0.5) * block_size
        starts = np.cumsum([0] + [c for _, c in buckets])[:-1]
        bucket_centers = centers_cell[starts].astype(np.float32) \
            if len(buckets) else np.zeros((0, 3), np.float32)
        bucket_of = np.repeat(np.arange(len(buckets)),
                              [c for _, c in buckets])

        scale_range = 32767
        sf = scale_range / (block_size * 0.5)
        delta = means[order] - bucket_centers[bucket_of]
        qpos = np.clip(np.rint(delta * sf) + scale_range, 0,
                       2 * scale_range + 1).astype("<u2")

        rows = np.zeros((n, bps), np.uint8)
        rows[:, 0:6] = qpos.view(np.uint8).reshape(n, 6)
        rows[:, 6:12] = _to_f16_bits(scales[order]).view(np.uint8
                                                         ).reshape(n, 6)
        rows[:, 12:20] = np.ascontiguousarray(
            _to_f16_bits(q_wxyz[order])).view(np.uint8).reshape(n, 8)
        rows[:, 20:24] = colors_u8[order]
        if comp:
            if level == 1:
                rows[:, 24:] = _to_f16_bits(sh_flat[order]).view(
                    np.uint8).reshape(n, comp * 2)
            else:
                rng = max(max_sh - min_sh, 1e-12)
                sh_u8 = np.clip(
                    np.floor((np.clip(sh_flat[order], min_sh, max_sh)
                              - min_sh) / rng * 255.0), 0, 255)
                rows[:, 24:] = sh_u8.astype(np.uint8)

    meta_bytes = len(partial_lens) * 4
    buckets_bytes = (BUCKET_STORAGE_BYTES * (full_buckets + len(partial_lens))
                     + meta_bytes) if level >= 1 else 0
    storage = n * bps + buckets_bytes
    body = bytearray(storage)
    base = 0
    if level >= 1:
        if len(partial_lens):
            np.frombuffer(body, "<u4", len(partial_lens), 0)[:] = partial_lens
        cb = meta_bytes
        np.frombuffer(body, "<f4", bucket_centers.size, cb)[:] = \
            bucket_centers.ravel()
        base = buckets_bytes
    body[base:base + n * bps] = rows.tobytes()
    fields = {
        "n": n,
        "bucket_size": bucket_size,
        "bucket_count": full_buckets + len(partial_lens),
        "block_size": block_size,
        "full_buckets": full_buckets,
        "partial_buckets": len(partial_lens),
        "storage": storage,
        "sh_degree": sh_degree,
    }
    return fields, bytes(body)


def serialize_ksplat_sections(sections, compression_level: int = 0,
                              block_size: float = DEFAULT_BLOCK_SIZE,
                              bucket_size: int = DEFAULT_BUCKET_SIZE,
                              minimum_alpha: float = 0.0) -> bytes:
    """Encode one or more SplatData sections as a .ksplat buffer.

    Multi-section output mirrors generateFromUncompressedSplatArrays over a
    partitioned splat array (SplatBuffer.js:1177-1326 with the
    SplatPartitioner's section list); the shared SH min/max range and
    degree are computed globally across sections.
    """
    if compression_level not in (0, 1, 2):
        raise ValueError("compression_level must be 0, 1 or 2")
    level = compression_level
    max_deg = min(2, max(sec.sh_degree for sec in sections))
    arrs = [_prep_section(sec, minimum_alpha, max_deg) for sec in sections]

    if max_deg:
        min_sh = min(float(a[4].min()) for a in arrs if a[4].size)
        max_sh = max(float(a[4].max()) for a in arrs if a[4].size)
    else:
        min_sh, max_sh = -_SH_HALF_RANGE, _SH_HALF_RANGE

    encoded = [_encode_section(a, level, max_deg, block_size, bucket_size,
                               min_sh, max_sh) for a in arrs]
    total = sum(f["n"] for f, _ in encoded)
    nsec = len(encoded)

    size = (HEADER_BYTES + SECTION_HEADER_BYTES * nsec
            + sum(len(b) for _, b in encoded))
    out = bytearray(size)
    out[0] = 0
    out[1] = 1
    np.frombuffer(out, "<u4", 5, 0)[1:5] = [nsec, nsec, total, total]
    np.frombuffer(out, "<u2", 11, 0)[10] = level
    all_means = np.concatenate([a[0] for a in arrs]) if total else \
        np.zeros((1, 3), np.float32)
    np.frombuffer(out, "<f4", 11, 0)[6:9] = all_means.mean(axis=0)
    np.frombuffer(out, "<f4", 11, 0)[9:11] = [min_sh, max_sh]

    data_base = HEADER_BYTES + SECTION_HEADER_BYTES * nsec
    for i, (f, body) in enumerate(encoded):
        shdr = HEADER_BYTES + i * SECTION_HEADER_BYTES
        u32 = np.frombuffer(out, "<u4", 10, shdr)
        u16 = np.frombuffer(out, "<u2", 21, shdr)
        f32 = np.frombuffer(out, "<f4", 5, shdr)
        u32[0] = f["n"]
        u32[1] = f["n"]
        if level >= 1:
            u32[2] = f["bucket_size"]
            u32[3] = f["bucket_count"]
            f32[4] = f["block_size"]
            u16[10] = BUCKET_STORAGE_BYTES
            u32[6] = 32767
            u32[8] = f["full_buckets"]
            u32[9] = f["partial_buckets"]
        u32[7] = f["storage"]
        u16[20] = f["sh_degree"]
        out[data_base:data_base + len(body)] = body
        data_base += len(body)
    return bytes(out)


def serialize_ksplat(splats: SplatData, compression_level: int = 0,
                     block_size: float = DEFAULT_BLOCK_SIZE,
                     bucket_size: int = DEFAULT_BUCKET_SIZE,
                     minimum_alpha: float = 0.0,
                     section_size: int | None = None) -> bytes:
    """Encode SplatData as a .ksplat buffer.

    ``section_size`` splits the data into multiple sections (progressive-
    load friendly, like the reference's partitioned output)."""
    if section_size and section_size < splats.num_splats:
        sections = []
        n = splats.num_splats
        for start in range(0, n, section_size):
            sl = slice(start, min(start + section_size, n))
            sections.append(SplatData(*(getattr(splats, f)[sl] for f in (
                "means", "scales", "quats", "colors", "sh"))))
        return serialize_ksplat_sections(sections, compression_level,
                                         block_size, bucket_size,
                                         minimum_alpha)
    return serialize_ksplat_sections([splats], compression_level,
                                     block_size, bucket_size, minimum_alpha)


def save_ksplat(splats: SplatData, path: str, compression_level: int = 0,
                **kw) -> None:
    with open(path, "wb") as f:
        f.write(serialize_ksplat(splats, compression_level, **kw))

