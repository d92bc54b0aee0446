"""Niantic ``.spz`` format (gzip-wrapped packed gaussians): reader + writer.

Counterpart of the JAX package's ``io/spz.py``.  Layout per the reference
loader (src/loaders/spz/SpzLoader.js:255-342 deserialize, :160-250
unpack):

    gzip( 16-byte header | positions | alphas | colors | scales |
          rotations | sh )

    header: u32 magic 0x5053474e ("NGSP"), u32 version (1: f16 positions,
            2: 24-bit fixed point), u32 numPoints, u8 shDegree (0-3),
            u8 fractionalBits, u8 flags (bit 0 = antialiased), u8 reserved.

Decode transforms (:196-239):
    position: 24-bit little-endian signed fixed point * 2^-fractionalBits
    scale:    exp(u8 / 16 - 10)
    rotation: xyz = u8 / 127.5 - 1, w = sqrt(max(0, 1 - |xyz|^2))
    alpha:    u8 / 255 (sigmoid already applied)
    color:    ((u8 / 255 - 0.5) / 0.15) * SH_C0 + 0.5
    sh:       (u8 - 128) / 128, stored coefficient-major (k, then rgb) —
              the same [N, K, 3] order as SplatData.sh.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

from ..constants import SH_C0
from ..core.types import SplatData
from ._arrays import host_arrays, to_splatdata

SPZ_MAGIC = 1347635022          # 'NGSP' little-endian
FLAG_ANTIALIASED = 1
COLOR_SCALE = 0.15
SH_DIM = {0: 0, 1: 3, 2: 8, 3: 15}
MAX_POINTS = 10_000_000


def parse_spz(data: bytes, sh_degree: int | None = None,
              device="cuda") -> SplatData:
    raw = gzip.decompress(data)
    if len(raw) < 16:
        raise ValueError(".spz: truncated header")
    magic, version, n, deg, frac_bits, flags, _ = struct.unpack(
        "<IIIBBBB", raw[:16])
    if magic != SPZ_MAGIC:
        raise ValueError(".spz: bad magic")
    if not (1 <= version <= 2):
        raise ValueError(f".spz: unsupported version {version}")
    if n > MAX_POINTS:
        raise ValueError(f".spz: too many points ({n})")
    if deg > 3:
        raise ValueError(f".spz: unsupported SH degree {deg}")

    shdim = SH_DIM[deg]
    uses_f16 = version == 1
    pos_bytes = n * 3 * (2 if uses_f16 else 3)
    sizes = [pos_bytes, n, n * 3, n * 3, n * 3, n * shdim * 3]
    if len(raw) != 16 + sum(sizes):
        raise ValueError(".spz: incorrect buffer size")
    off = 16
    sections = []
    for sz in sizes:
        sections.append(np.frombuffer(raw, np.uint8, sz, off))
        off += sz
    positions_b, alphas_b, colors_b, scales_b, rotations_b, sh_b = sections

    if uses_f16:
        means = positions_b.view("<f2").astype(np.float32).reshape(n, 3)
    else:
        b = positions_b.reshape(n, 3, 3).astype(np.int32)
        fixed = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
        fixed = np.where(fixed & 0x800000, fixed - (1 << 24), fixed)
        means = fixed.astype(np.float32) / float(1 << frac_bits)

    scales = np.exp(scales_b.astype(np.float32).reshape(n, 3) / 16.0 - 10.0)

    xyz = rotations_b.astype(np.float32).reshape(n, 3) / 127.5 - 1.0
    w = np.sqrt(np.maximum(0.0, 1.0 - np.sum(xyz * xyz, axis=1)))
    quats = np.concatenate([xyz, w[:, None]], axis=1)

    opacity = alphas_b.astype(np.float32) / 255.0
    col = colors_b.astype(np.float32).reshape(n, 3) / 255.0
    rgb = ((col - 0.5) / COLOR_SCALE) * SH_C0 + 0.5
    rgb = np.clip(np.floor(rgb * 255.0), 0, 255) / 255.0

    out_deg = deg if sh_degree is None else min(sh_degree, deg)
    k = SH_DIM[out_deg]
    sh = ((sh_b.astype(np.float32) - 128.0) / 128.0
          ).reshape(n, shdim, 3)[:, :k, :]

    colors = np.concatenate([rgb, opacity[:, None]], axis=1
                            ).astype(np.float32)
    return to_splatdata(means, scales, quats, colors, sh, device)


def load_spz(path: str, sh_degree: int | None = None,
             device="cuda") -> SplatData:
    with open(path, "rb") as f:
        return parse_spz(f.read(), sh_degree, device)


def serialize_spz(splats: SplatData, fractional_bits: int = 12,
                  antialiased: bool = False) -> bytes:
    """Encode SplatData as .spz v2 (inverse of the decode transforms)."""
    means, scales, quats, colors, sh = host_arrays(splats)
    n, k = means.shape[0], sh.shape[1]
    deg = {0: 0, 3: 1, 8: 2, 15: 3}[k]

    header = struct.pack("<IIIBBBB", SPZ_MAGIC, 2, n, deg, fractional_bits,
                         FLAG_ANTIALIASED if antialiased else 0, 0)

    fixed = np.clip(np.rint(means * (1 << fractional_bits)),
                    -(1 << 23), (1 << 23) - 1).astype(np.int32)
    fixed = np.where(fixed < 0, fixed + (1 << 24), fixed)
    pos = np.zeros((n, 3, 3), np.uint8)
    pos[..., 0] = fixed & 0xFF
    pos[..., 1] = (fixed >> 8) & 0xFF
    pos[..., 2] = (fixed >> 16) & 0xFF

    alphas = np.clip(np.rint(colors[:, 3] * 255.0), 0, 255).astype(np.uint8)
    col = (colors[:, :3] - 0.5) / SH_C0 * COLOR_SCALE + 0.5
    col_b = np.clip(np.rint(col * 255.0), 0, 255).astype(np.uint8)
    sc_b = np.clip(np.rint((np.log(np.maximum(scales, 1e-12)) + 10.0) * 16.0),
                   0, 255).astype(np.uint8)
    q = quats / np.maximum(np.linalg.norm(quats, axis=1, keepdims=True),
                           1e-12)
    q = np.where(q[:, 3:4] < 0, -q, q)        # keep w >= 0
    rot_b = np.clip(np.rint((q[:, :3] + 1.0) * 127.5), 0, 255
                    ).astype(np.uint8)
    sh_b = np.clip(np.rint(sh * 128.0 + 128.0), 0, 255).astype(np.uint8)

    raw = (header + pos.tobytes() + alphas.tobytes() + col_b.tobytes()
           + sc_b.tobytes() + rot_b.tobytes() + sh_b.tobytes())
    return gzip.compress(raw)


def save_spz(splats: SplatData, path: str, **kw) -> None:
    with open(path, "wb") as f:
        f.write(serialize_spz(splats, **kw))
