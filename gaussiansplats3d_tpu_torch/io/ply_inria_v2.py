"""INRIA "V2" codebook-quantized ``.ply`` variant.

Counterpart of the JAX package's ``io/ply_inria_v2.py``.  Mirrors the
reference's src/loaders/ply/INRIAV2PlyParser.js: a
`codebook_centers` element holds half-float codebook pages (features_dc,
features_rest_0..14, opacity, scaling, rotation_re, rotation_im); vertex
sections store integer indices into those pages.  Decode transforms
(:146-158): opacity -> sigmoid, features_dc -> 0.5 + SH_C0 * v, scaling ->
exp(v); positions are half floats in the vertex record (:264-266); rotation
uses the `rotation_re` page for the scalar and `rotation_im` for the
imaginary parts, normalized (:252-257).
"""

from __future__ import annotations

import numpy as np

from ..constants import SH_C0
from ..core.types import SplatData
from ._arrays import to_splatdata
from .ply import _PLY_DTYPES, parse_ply_header

_REST_PAGES_DEG1 = 3    # features_rest_{i % 3} for the 9 degree-1 coeffs
_REST_PAGES_DEG2 = 5    # features_rest_{3 + i % 5} for the 15 degree-2


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def parse_ply_inria_v2(data: bytes, sh_degree: int | None = None,
                       device="cuda") -> SplatData:
    header = parse_ply_header(data)
    if header.format != "binary_little_endian":
        raise ValueError("INRIA V2 PLY must be binary little endian")

    tables = {}
    offset = header.header_size
    for el_name, count, props in header.elements:
        dtype = np.dtype([(p, _PLY_DTYPES[t]) for p, t in props])
        tables[el_name] = np.frombuffer(data, dtype, count, offset)
        offset += dtype.itemsize * count

    cb = tables.pop("codebook_centers", None)
    if cb is None:
        raise ValueError("INRIA V2 PLY missing codebook_centers element")

    def page(name):
        return np.asarray(cb[name], "<u2").view(np.float16
                                                ).astype(np.float32)

    pg_dc = np.clip(np.round((0.5 + SH_C0 * page("features_dc")) * 255),
                    0, 255)
    pg_opacity = np.clip(np.round(_sigmoid(page("opacity")) * 255), 0, 255)
    pg_scaling = np.exp(page("scaling"))
    pg_rot_re = page("rotation_re")
    pg_rot_im = page("rotation_im")
    pg_rest = [page(f"features_rest_{i}") for i in range(15)]

    parts = []
    for el_name, verts in tables.items():
        names = set(verts.dtype.names)
        n = verts.shape[0]

        def idx(col):
            return np.asarray(verts[col]).astype(np.int64)

        means = np.stack(
            [np.asarray(verts[c], "<u2").view(np.float16).astype(np.float32)
             for c in ("x", "y", "z")], axis=1)
        scales = np.stack([pg_scaling[idx(f"scale_{i}")] for i in range(3)],
                          axis=1)
        rot_wxyz = np.stack([
            pg_rot_re[idx("rot_0")], pg_rot_im[idx("rot_1")],
            pg_rot_im[idx("rot_2")], pg_rot_im[idx("rot_3")]], axis=1)
        rot_wxyz /= np.maximum(
            np.linalg.norm(rot_wxyz, axis=1, keepdims=True), 1e-12)
        quats = rot_wxyz[:, [1, 2, 3, 0]]
        rgb = np.stack([pg_dc[idx(f"f_dc_{i}")] for i in range(3)], axis=1)
        opacity = pg_opacity[idx("opacity")]
        colors = np.concatenate(
            [np.floor(rgb) / 255.0, (np.floor(opacity) / 255.0)[:, None]],
            axis=1).astype(np.float32)

        n_rest = sum(1 for c in names if c.startswith("f_rest_"))
        coeffs_per_channel = n_rest // 3
        file_deg = (2 if coeffs_per_channel >= 8 else
                    1 if coeffs_per_channel >= 3 else 0)
        out_deg = file_deg if sh_degree is None else min(sh_degree, file_deg)
        k = {0: 0, 1: 3, 2: 8}[out_deg]
        sh = np.zeros((n, k, 3), np.float32)
        # degree-1: fields f_rest_{i + cpc*rgb} for i in 0..2; page i % 3
        for ch in range(3 if k else 0):
            for i in range(min(k, 3)):
                col = idx(f"f_rest_{i + coeffs_per_channel * ch}")
                sh[:, i, ch] = pg_rest[i % _REST_PAGES_DEG1][col]
            for i in range(3, k):
                col = idx(f"f_rest_{i + coeffs_per_channel * ch}")
                sh[:, i, ch] = pg_rest[3 + (i - 3) % _REST_PAGES_DEG2][col]
        parts.append((means, scales, quats.astype(np.float32), colors, sh))

    kmax = max(p[4].shape[1] for p in parts)
    shs = [np.concatenate(
        [p[4], np.zeros((p[4].shape[0], kmax - p[4].shape[1], 3),
                        np.float32)], axis=1) for p in parts]
    return to_splatdata(np.concatenate([p[0] for p in parts]),
                        np.concatenate([p[1] for p in parts]),
                        np.concatenate([p[2] for p in parts]),
                        np.concatenate([p[3] for p in parts]),
                        np.concatenate(shs), device)
