"""3D covariance from scale/rotation (counterpart of the JAX package's
``core/covariance.py``).

Matches the reference's `SplatBuffer.computeCovariance`
(src/loaders/SplatBuffer.js:440-486): C = R @ S, Sigma = C @ C^T, and
with a scene transform T3 (the upper-left 3x3 of the 4x4)
Sigma' = T3 @ Sigma @ T3^T.  The renderer's hot path uses the flat
per-splat entries (:func:`covariance6_elements`).
"""

from __future__ import annotations

import torch

from .math3d import normalize, quat_to_rotmat


def covariance_from_scale_quat(scales: torch.Tensor, quats: torch.Tensor,
                               transform3: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """Full 3x3 covariance matrices ``[N, 3, 3]`` from ``scales [N, 3]``
    and ``quats [N, 4]`` (x, y, z, w), with an optional ``[3, 3]`` scene
    transform applied congruently."""
    m = quat_to_rotmat(quats) * scales[:, None, :]          # R @ diag(s)
    cov = m @ m.transpose(-1, -2)
    if transform3 is not None:
        cov = transform3[None] @ cov @ transform3.T[None]
    return cov


def covariance6(scales: torch.Tensor, quats: torch.Tensor,
                transform3: torch.Tensor | None = None) -> torch.Tensor:
    """Compact symmetric covariance ``[N, 6]``: (xx, xy, xz, yy, yz, zz),
    the order the reference packs (SplatBuffer.js:469-483)."""
    cov = covariance_from_scale_quat(scales, quats, transform3)
    return torch.stack([cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2],
                        cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2]], dim=-1)


def covariance6_elements(scales: torch.Tensor, quats: torch.Tensor):
    """The 6 unique covariance entries as separate [N] tensors
    (xx, xy, xz, yy, yz, zz): Sigma_ij = sum_k s_k^2 R_ik R_jk."""
    q = normalize(quats)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r00 = 1 - 2 * (yy + zz)
    r01 = 2 * (xy - wz)
    r02 = 2 * (xz + wy)
    r10 = 2 * (xy + wz)
    r11 = 1 - 2 * (xx + zz)
    r12 = 2 * (yz - wx)
    r20 = 2 * (xz - wy)
    r21 = 2 * (yz + wx)
    r22 = 1 - 2 * (xx + yy)
    s0 = scales[..., 0] ** 2
    s1 = scales[..., 1] ** 2
    s2 = scales[..., 2] ** 2
    c_xx = s0 * r00 * r00 + s1 * r01 * r01 + s2 * r02 * r02
    c_xy = s0 * r00 * r10 + s1 * r01 * r11 + s2 * r02 * r12
    c_xz = s0 * r00 * r20 + s1 * r01 * r21 + s2 * r02 * r22
    c_yy = s0 * r10 * r10 + s1 * r11 * r11 + s2 * r12 * r12
    c_yz = s0 * r10 * r20 + s1 * r11 * r21 + s2 * r12 * r22
    c_zz = s0 * r20 * r20 + s1 * r21 * r21 + s2 * r22 * r22
    return c_xx, c_xy, c_xz, c_yy, c_yz, c_zz


def quadratic_form6(cov6, u, v):
    """u^T Sigma v with Sigma given as 6 unique entries and u, v as
    row-component tuples (u0, u1, u2) of [N] tensors."""
    c_xx, c_xy, c_xz, c_yy, c_yz, c_zz = cov6
    u0, u1, u2 = u
    v0, v1, v2 = v
    return (c_xx * u0 * v0 + c_yy * u1 * v1 + c_zz * u2 * v2
            + c_xy * (u0 * v1 + u1 * v0)
            + c_xz * (u0 * v2 + u2 * v0)
            + c_yz * (u1 * v2 + u2 * v1))
