"""PlayCanvas compressed ``.ply`` variant (chunked-quantized splats).

Counterpart of the JAX package's ``io/ply_playcanvas.py``.  Mirrors the
reference's src/loaders/ply/PlayCanvasCompressedPlyParser.js:

- `chunk` element: per-256-splat f32 min/max of position, log-scale and
  (optionally) color (:319-340).
- `vertex` element: four u32s per splat — packed_position (11-10-11 unorm
  lerped within the chunk's box, :26-30, :394), packed_rotation
  (2-bit largest-component index + 3x10-bit smallest-three, scalar-first
  order, scaled by sqrt(2), :40-61), packed_scale (11-10-11 unorm over the
  chunk's log-scale range, exp'd), packed_color (8888 unorm RGBA, RGB
  optionally lerped in the chunk's color range).
- optional `sh` element: u8 coefficients, value * 8/255 - 4, channel-major
  per band (:decompressSphericalHarmonics).
"""

from __future__ import annotations

import numpy as np

from ..core.types import SplatData
from ._arrays import to_splatdata
from .ply import PlyHeader, parse_ply_header

_SQRT2 = float(np.sqrt(2.0))


def _unorm(v: np.ndarray, bits: int) -> np.ndarray:
    return v.astype(np.float32) / ((1 << bits) - 1)


def _unpack_111011(u: np.ndarray):
    return (_unorm(u >> 21, 11), _unorm((u >> 11) & 0x3FF, 10),
            _unorm(u & 0x7FF, 11))


def _element_table(data: bytes, header: PlyHeader, name: str):
    """Return (recarray, offset_after) for the named element (binary LE)."""
    from .ply import _PLY_DTYPES
    offset = header.header_size
    for el_name, count, props in header.elements:
        dtype = np.dtype([(p, _PLY_DTYPES[t]) for p, t in props])
        if el_name == name:
            return np.frombuffer(data, dtype, count, offset)
        offset += dtype.itemsize * count
    return None


def parse_ply_playcanvas(data: bytes, sh_degree: int | None = None,
                         device="cuda") -> SplatData:
    header = parse_ply_header(data)
    if header.format != "binary_little_endian":
        raise ValueError("PlayCanvas compressed PLY must be binary LE")
    chunks = _element_table(data, header, "chunk")
    verts = _element_table(data, header, "vertex")
    shel = _element_table(data, header, "sh")
    if chunks is None or verts is None:
        raise ValueError("PlayCanvas PLY missing chunk/vertex elements")

    n = verts.shape[0]
    chunk_of = np.arange(n) // 256

    def ch(name):
        return np.asarray(chunks[name], np.float32)[chunk_of]

    # positions
    px, py, pz = _unpack_111011(np.asarray(verts["packed_position"],
                                           np.uint32))
    means = np.stack([
        ch("min_x") + (ch("max_x") - ch("min_x")) * px,
        ch("min_y") + (ch("max_y") - ch("min_y")) * py,
        ch("min_z") + (ch("max_z") - ch("min_z")) * pz], axis=1)

    # scales (log space in chunk range, exp'd)
    sx, sy, sz = _unpack_111011(np.asarray(verts["packed_scale"], np.uint32))
    scales = np.exp(np.stack([
        ch("min_scale_x") + (ch("max_scale_x") - ch("min_scale_x")) * sx,
        ch("min_scale_y") + (ch("max_scale_y") - ch("min_scale_y")) * sy,
        ch("min_scale_z") + (ch("max_scale_z") - ch("min_scale_z")) * sz],
        axis=1))

    # rotation: largest-component index in bits 30-31; (a, b, c) are the
    # remaining components scalar-first (w, x, y, z order)
    pr = np.asarray(verts["packed_rotation"], np.uint32)
    # the reference computes (u - 0.5) / (sqrt(2) * 0.5) == (u - 0.5)*sqrt(2)
    a = (_unorm((pr >> 20) & 0x3FF, 10) - 0.5) * _SQRT2
    b = (_unorm((pr >> 10) & 0x3FF, 10) - 0.5) * _SQRT2
    c = (_unorm(pr & 0x3FF, 10) - 0.5) * _SQRT2
    m = np.sqrt(np.maximum(0.0, 1.0 - (a * a + b * b + c * c)))
    which = (pr >> 30).astype(np.int32)
    wxyz = np.empty((n, 4), np.float32)
    for case in range(4):
        sel = which == case
        comps = [a[sel], b[sel], c[sel]]
        comps.insert(case, m[sel])
        wxyz[sel] = np.stack(comps, axis=1)
    quats = wxyz[:, [1, 2, 3, 0]]

    # color
    pc = np.asarray(verts["packed_color"], np.uint32)
    r8 = _unorm(pc >> 24, 8)
    g8 = _unorm((pc >> 16) & 0xFF, 8)
    b8 = _unorm((pc >> 8) & 0xFF, 8)
    a8 = _unorm(pc & 0xFF, 8)
    chunk_names = chunks.dtype.names
    if "min_r" in chunk_names:
        r8 = ch("min_r") + (ch("max_r") - ch("min_r")) * r8
        g8 = ch("min_g") + (ch("max_g") - ch("min_g")) * g8
        b8 = ch("min_b") + (ch("max_b") - ch("min_b")) * b8
        rgb = np.clip(np.round(np.stack([r8, g8, b8], 1) * 255), 0, 255) / 255
    else:
        rgb = np.clip(np.floor(np.stack([r8, g8, b8], 1) * 255), 0, 255) / 255
    opacity = np.clip(np.floor(a8 * 255), 0, 255) / 255

    # SH
    file_deg = 0
    k = 0
    if shel is not None:
        coeffs = len(shel.dtype.names) // 3
        file_deg = 3 if coeffs >= 15 else 2 if coeffs >= 8 else \
            1 if coeffs >= 3 else 0
        out_deg = file_deg if sh_degree is None else min(sh_degree, file_deg)
        k = {0: 0, 1: 3, 2: 8, 3: 15}[out_deg]
    sh = np.zeros((n, k, 3), np.float32)
    if k:
        for j in range(3):
            for i in range(k):
                col = np.asarray(shel[f"f_rest_{j * coeffs + i}"], np.float32)
                sh[:, i, j] = col * (8.0 / 255.0) - 4.0

    colors = np.concatenate([rgb, opacity[:, None]], axis=1
                            ).astype(np.float32)
    return to_splatdata(means, scales, quats, colors, sh, device)
