"""Spherical-harmonics color evaluation, degrees 0-3 (counterpart of the JAX
package's ``core/sh.py``), and their rotation under rigid scene transforms.

Matches the reference vertex shader (src/splatmesh/SplatMaterial.js:263-342):
the DC band is pre-baked into ``base_rgb``; higher bands add view-dependent
terms of the normalized camera->splat direction; clamp to [0, 1] when
degree >= 1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import SH_C1, SH_C2, SH_C3


def eval_sh_color(base_rgb: torch.Tensor, sh: torch.Tensor,
                  dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """``base_rgb [N, 3]``, ``sh [N, K, 3]``, ``dirs [N, 3]`` -> ``[N, 3]``."""
    if degree == 0:
        return base_rgb
    x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
    color = base_rgb + SH_C1 * (-sh[:, 0] * y + sh[:, 1] * z - sh[:, 2] * x)
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        color = color + ((SH_C2[0] * xy) * sh[:, 3] +
                         (SH_C2[1] * yz) * sh[:, 4] +
                         (SH_C2[2] * (2.0 * zz - xx - yy)) * sh[:, 5] +
                         (SH_C2[3] * xz) * sh[:, 6] +
                         (SH_C2[4] * (xx - yy)) * sh[:, 7])
    if degree >= 3:
        color = color + (
            (SH_C3[0] * y * (3.0 * xx - yy)) * sh[:, 8] +
            (SH_C3[1] * xy * z) * sh[:, 9] +
            (SH_C3[2] * y * (4.0 * zz - xx - yy)) * sh[:, 10] +
            (SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy)) * sh[:, 11] +
            (SH_C3[4] * x * (4.0 * zz - xx - yy)) * sh[:, 12] +
            (SH_C3[5] * z * (xx - yy)) * sh[:, 13] +
            (SH_C3[6] * x * (xx - 3.0 * yy)) * sh[:, 14])
    return torch.clamp(color, 0.0, 1.0)


# --- SH rotation under rigid scene transforms --------------------------------
#
# When a scene is composed with a rotation R, the degree-1 band rotates in the
# permuted (y, z, x) basis and degree-2 rotates via the standard real-SH
# Wigner construction.  The reference implements the same thing numerically at
# SplatBuffer.js:634-636, 766-817.

# The degree-1 basis functions are (up to SH_C1) (-y, z, -x).  Writing the
# coefficient vector as a 3-vector v via v = A sh with A = [[0,0,-1],
# [-1,0,0],[0,1,0]], rotated coefficients are sh' = A^-1 R A sh, which works
# out to M[i, j] = s_i s_j R[p_i, p_j] with p = (1, 2, 0), s = (-1, 1, -1).
_SH1_PERM = [1, 2, 0]
_SH1_SIGN = np.array([-1.0, 1.0, -1.0], dtype=np.float32)


def rotate_sh1(sh1: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Rotate degree-1 SH triplets ``[N, 3, 3]`` (coeff, rgb) by ``rot [3,3]``."""
    m = rot[_SH1_PERM][:, _SH1_PERM] * torch.as_tensor(
        np.outer(_SH1_SIGN, _SH1_SIGN), device=rot.device)
    return torch.einsum("ij,njc->nic", m, sh1)


def _sh2_basis(d: torch.Tensor) -> torch.Tensor:
    """Unnormalized real degree-2 SH basis evaluated at direction d [3]."""
    x, y, z = d[0], d[1], d[2]
    return torch.stack([x * y, y * z, 3.0 * z * z - 1.0, x * z, x * x - y * y])


# Sample directions whose degree-2 SH evaluations form an invertible 5x5.
_SH2_DIRS = np.array(
    [
        [1.0, 1.0, 0.0],
        [0.0, 1.0, 1.0],
        [1.0, 0.0, 1.0],
        [1.0, -1.0, 0.0],
        [0.0, 1.0, -1.0],
    ],
    dtype=np.float64,
)
_SH2_DIRS /= np.linalg.norm(_SH2_DIRS, axis=1, keepdims=True)


def _sh2_matrix(dirs: np.ndarray) -> np.ndarray:
    out = np.zeros((5, 5))
    for i, d in enumerate(dirs):
        x, y, z = d
        out[i] = [x * y, y * z, 3.0 * z * z - 1.0, x * z, x * x - y * y]
    return out


# a host-side float64 solve, once
_SH2_A_INV = np.linalg.inv(_sh2_matrix(_SH2_DIRS))


def sh2_rotation_matrix(rot: torch.Tensor) -> torch.Tensor:
    """5x5 matrix rotating degree-2 SH coefficients by world rotation `rot`.

    Constructed by evaluating the basis at rotated sample directions — the
    same numerical approach as the reference's degree-2 path
    (SplatBuffer.js:772-817).

    Derivation: we need sh' with b(d)^T sh' = b(R^T d)^T sh for all unit d.
    Sampling at the 5 invertible directions d_i gives sh' = A^-1 B sh with
    A[i] = b(d_i) and B[i] = b(R^T d_i).

    Because evaluation scales component i by SH_C2[i] (signs included), the
    matrix is conjugated by K = diag(SH_C2).
    """
    dev = rot.device
    rotated = torch.as_tensor(_SH2_DIRS, dtype=torch.float32,
                              device=dev) @ rot      # rows are R^T d_i
    b = torch.stack([_sh2_basis(rotated[i]) for i in range(5)])
    m_unscaled = torch.as_tensor(_SH2_A_INV, dtype=torch.float32,
                                 device=dev) @ b
    k = torch.as_tensor(SH_C2, dtype=torch.float32, device=dev)
    return m_unscaled * (k[None, :] / k[:, None])


def rotate_sh(sh: torch.Tensor, rot: torch.Tensor, degree: int
              ) -> torch.Tensor:
    """Rotate ``[N, K, 3]`` SH coefficients by rotation matrix ``rot``."""
    if degree < 1 or sh.shape[1] == 0:
        return sh
    out = [rotate_sh1(sh[:, 0:3], rot)]
    if degree >= 2 and sh.shape[1] >= 8:
        m2 = sh2_rotation_matrix(rot)
        out.append(torch.einsum("ij,njc->nic", m2, sh[:, 3:8]))
        if sh.shape[1] > 8:
            # Degree-3 rotation is not implemented; pass through unchanged
            # (the reference does not rotate degree 3 either).
            out.append(sh[:, 8:])
    elif sh.shape[1] > 3:
        out.append(sh[:, 3:])
    return torch.cat(out, dim=1)
