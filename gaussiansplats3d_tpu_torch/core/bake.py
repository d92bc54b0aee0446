"""Bake a static scene transform into splat data (counterpart of the JAX
package's ``core/bake.py``).

The reference bakes static scene transforms directly into the GPU buffers —
centers through the matrix, scale/rotation through a compose+decompose
(src/loaders/SplatBuffer.js:349-440), and the spherical harmonics through
the degree-1/2 rotation construction (SplatBuffer.js:634-636, 766-817).
``bake_transform`` returns a NEW SplatData equal to rendering the original
with ``transforms=[tf]``, so a static multi-scene composition can collapse
to a single identity-transform buffer.  The per-splat decompose runs in
numpy on the host (the JAX package's arithmetic, batched); the SH rotation
runs on the splats' device.
"""

from __future__ import annotations

import numpy as np
import torch

from .sh import rotate_sh
from .types import SplatData


def _quats_to_rotmats(q: np.ndarray) -> np.ndarray:
    """Batched (x, y, z, w) quaternions -> [N, 3, 3] rotation matrices."""
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1),
    ], axis=1)


def _rotmats_to_quats(m: np.ndarray) -> np.ndarray:
    """Batched [N, 3, 3] rotations -> (x, y, z, w), w >= 0 (the reference's
    ensurePositiveW convention, SplatBuffer.js:357-364)."""
    t = np.trace(m, axis1=1, axis2=2)
    qw = np.sqrt(np.maximum(0.0, 1.0 + t)) / 2.0
    qx = np.sqrt(np.maximum(0.0, 1.0 + m[:, 0, 0] - m[:, 1, 1]
                            - m[:, 2, 2])) / 2.0
    qy = np.sqrt(np.maximum(0.0, 1.0 - m[:, 0, 0] + m[:, 1, 1]
                            - m[:, 2, 2])) / 2.0
    qz = np.sqrt(np.maximum(0.0, 1.0 - m[:, 0, 0] - m[:, 1, 1]
                            + m[:, 2, 2])) / 2.0
    qx = np.copysign(qx, m[:, 2, 1] - m[:, 1, 2])
    qy = np.copysign(qy, m[:, 0, 2] - m[:, 2, 0])
    qz = np.copysign(qz, m[:, 1, 0] - m[:, 0, 1])
    q = np.stack([qx, qy, qz, qw], axis=-1)
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    flip = np.where(q[:, 3:4] < 0, -1.0, 1.0)
    return q * flip


def bake_transform(splats: SplatData, transform) -> SplatData:
    """Apply a 4x4 TRS transform permanently to the splat data.

    Semantics match the reference's fill* accessors under a transform:
    means through the matrix, per-splat (scale, rotation) from decomposing
    ``transform @ R(q) @ S(s)`` column-norm style (THREE.Matrix4.decompose),
    SH coefficients rotated by the transform's rotation part.  The
    transform must be rigid + uniform scale (the same assumption the
    reference's decompose path makes).  The result lives on the splats'
    device.
    """
    if isinstance(transform, torch.Tensor):
        transform = transform.detach().cpu().numpy()
    tf = np.asarray(transform, np.float32).reshape(4, 4)
    a = tf[:3, :3]
    dev = splats.device

    def host(x):
        return x.detach().cpu().numpy()

    means_new = host(splats.means) @ a.T + tf[:3, 3]

    r = _quats_to_rotmats(host(splats.quats))       # [N, 3, 3]
    m = np.einsum("ij,njk->nik", a, r)              # A R
    col_scale = np.linalg.norm(m, axis=1)           # [N, 3] column lengths
    # negative-determinant transforms are out of contract (like the
    # reference's decompose, which would flip scale.x)
    scales_new = host(splats.scales) * col_scale
    r_new = m / np.maximum(col_scale[:, None, :], 1e-12)
    quats_new = _rotmats_to_quats(r_new)

    sh = splats.sh
    if sh.shape[1] > 0:
        a_rot = a / np.maximum(np.linalg.norm(a, axis=0, keepdims=True),
                               1e-12)
        degree = {3: 1, 8: 2, 15: 3}[sh.shape[1]]
        sh = rotate_sh(sh, torch.as_tensor(a_rot, dtype=torch.float32,
                                           device=dev), degree)

    def dev_f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return SplatData(means=dev_f32(means_new), scales=dev_f32(scales_new),
                     quats=dev_f32(quats_new), colors=splats.colors,
                     sh=sh.to(torch.float32))
