"""antimatter15 ``.splat`` format: 32 bytes per splat, no header.

Counterpart of the JAX package's ``io/splat.py``: the native decoder
(``io/native.py``) where it loads, else the numpy rows.  Row layout
(reference: src/loaders/splat/SplatParser.js:13-56):

    3 x f32  position
    3 x f32  scale (linear, already exp'd)
    4 x u8   RGBA color (opacity already sigmoid'd)
    4 x u8   rotation quaternion, scalar-FIRST (w, x, y, z), each
             encoded as round(q * 128 + 128)

The quaternion is re-normalized after decode, matching the reference.
"""

from __future__ import annotations

import numpy as np

from ..core.types import SplatData
from . import native
from ._arrays import host_arrays, to_splatdata


def parse_splat(data: bytes, device="cuda") -> SplatData:
    """Decode a raw ``.splat`` byte buffer."""
    if len(data) % 32 != 0:
        raise ValueError(f".splat byte length {len(data)} is not a multiple "
                         "of the 32-byte row size")
    n = len(data) // 32
    decoded = native.parse_splat_native(data)
    if decoded is not None:
        return to_splatdata(*decoded, np.zeros((n, 0, 3), np.float32),
                            device)
    native.record_decode("splat", "numpy")
    rows = np.frombuffer(data, dtype=np.uint8).reshape(n, 32)
    f32 = rows[:, :24].copy().view("<f4")
    means = f32[:, 0:3]
    scales = f32[:, 3:6]
    colors = rows[:, 24:28].astype(np.float32) / 255.0
    q = (rows[:, 28:32].astype(np.float32) - 128.0) / 128.0   # (w, x, y, z)
    norm = np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    q = q / norm
    quats_xyzw = q[:, [1, 2, 3, 0]]
    return to_splatdata(means, scales, quats_xyzw, colors,
                        np.zeros((n, 0, 3), np.float32), device)


def load_splat(path: str, device="cuda") -> SplatData:
    with open(path, "rb") as f:
        return parse_splat(f.read(), device)


def serialize_splat(splats: SplatData) -> bytes:
    """Encode to the 32-byte-row format (drops SH — the format has none)."""
    # contiguous host copies: .view(np.uint8) needs a contiguous last axis
    means, scales, quats, colors, _ = host_arrays(splats)
    n = means.shape[0]
    rows = np.empty((n, 32), np.uint8)
    rows[:, 0:12] = means.astype("<f4").view(np.uint8)
    rows[:, 12:24] = scales.astype("<f4").view(np.uint8)
    rows[:, 24:28] = np.clip(np.rint(colors * 255.0), 0, 255).astype(np.uint8)
    norm = np.maximum(np.linalg.norm(quats, axis=1, keepdims=True), 1e-12)
    q = quats / norm
    wxyz = q[:, [3, 0, 1, 2]]
    rows[:, 28:32] = np.clip(np.rint(wxyz * 128.0 + 128.0), 0, 255
                             ).astype(np.uint8)
    return rows.tobytes()


def save_splat(splats: SplatData, path: str) -> None:
    with open(path, "wb") as f:
        f.write(serialize_splat(splats))
