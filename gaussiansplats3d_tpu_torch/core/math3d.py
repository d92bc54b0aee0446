"""3D math primitives on torch tensors (counterpart of the JAX package's
``core/math3d.py``).

Conventions
-----------
- Matrices are ``[r, c]`` row/column indexed and act on column vectors:
  ``v' = M @ v``.
- Quaternions are stored ``(x, y, z, w)`` (three.js order).  The quaternion →
  rotation-matrix formula matches the reference vertex shader
  (src/splatmesh/SplatMaterial.js:64-78) including its normalization.
- Cameras look down -Z in view space (GL convention).
- The matrix constructors take an explicit ``device``; they return float32.
"""

from __future__ import annotations

import math

import torch


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12
              ) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=dim, keepdim=True),
                           min=eps)


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """Quaternions ``[..., 4]`` (x, y, z, w) -> rotation matrices
    ``[..., 3, 3]``; normalizes internally like the reference shader."""
    q = normalize(quats)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
                        dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
                        dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
                        dim=-1),
        ],
        dim=-2,
    )


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix ``[3, 3]`` to quaternion (x, y, z, w). Not batched."""
    t = m[0, 0] + m[1, 1] + m[2, 2]
    # Branch-free Shepperd-style construction.
    qw = torch.sqrt(torch.clamp(1.0 + t, min=0.0)) / 2.0
    qx = torch.sqrt(torch.clamp(1.0 + m[0, 0] - m[1, 1] - m[2, 2],
                                min=0.0)) / 2.0
    qy = torch.sqrt(torch.clamp(1.0 - m[0, 0] + m[1, 1] - m[2, 2],
                                min=0.0)) / 2.0
    qz = torch.sqrt(torch.clamp(1.0 - m[0, 0] - m[1, 1] + m[2, 2],
                                min=0.0)) / 2.0
    qx = torch.copysign(qx, m[2, 1] - m[1, 2])
    qy = torch.copysign(qy, m[0, 2] - m[2, 0])
    qz = torch.copysign(qz, m[1, 0] - m[0, 1])
    return normalize(torch.stack([qx, qy, qz, qw]))


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions in (x, y, z, w) order, batched."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def compose_transform(position=None, quaternion=None, scale=None,
                      device="cuda") -> torch.Tensor:
    """Build a float32 4x4 affine transform on ``device`` from TRS
    components (three.js `compose`)."""
    r = (quat_to_rotmat(_vec3(quaternion, device)) if quaternion is not None
         else torch.eye(3, dtype=torch.float32, device=device))
    s = (_vec3(scale, device) if scale is not None
         else torch.ones(3, dtype=torch.float32, device=device))
    m = torch.eye(4, dtype=torch.float32, device=device)
    m[:3, :3] = r * s[None, :]
    if position is not None:
        m[:3, 3] = _vec3(position, device)
    return m


def transform_points(m: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 affine transform to points ``[..., 3]``."""
    return pts @ m[:3, :3].T + m[:3, 3]


def _vec3(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def look_at_view_matrix(eye, target, up=(0.0, 1.0, 0.0),
                        device="cuda") -> torch.Tensor:
    """World -> camera (view) matrix for a camera at `eye` looking at
    `target`; the camera looks down its local -Z axis."""
    eye, target, up = (_vec3(v, device) for v in (eye, target, up))
    z = normalize(eye - target)          # camera +Z points away from target
    x = normalize(torch.linalg.cross(up, z))
    y = torch.linalg.cross(z, x)
    r = torch.stack([x, y, z])           # rows: camera axes in world frame
    view = torch.eye(4, dtype=torch.float32, device=device)
    view[:3, :3] = r
    view[:3, 3] = -(r @ eye)
    return view


def perspective_projection(fov_y_deg: float, aspect: float, near: float,
                           far: float, device="cuda") -> torch.Tensor:
    """Standard GL perspective projection matrix (three.js
    PerspectiveCamera), evaluated in float32 like the JAX package."""
    fov = torch.tensor(fov_y_deg, dtype=torch.float32)
    f = 1.0 / torch.tan(fov * (math.pi / 180.0) / 2.0)
    m = torch.zeros((4, 4), dtype=torch.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2.0 * far * near / (near - far)
    m[3, 2] = -1.0
    return m.to(device)


def orthographic_projection(left: float, right: float, bottom: float,
                            top: float, near: float, far: float,
                            device="cuda") -> torch.Tensor:
    """Standard GL orthographic projection matrix (three.js
    OrthographicCamera)."""
    m = torch.zeros((4, 4), dtype=torch.float32)
    m[0, 0] = 2.0 / (right - left)
    m[1, 1] = 2.0 / (top - bottom)
    m[2, 2] = -2.0 / (far - near)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 3] = -(top + bottom) / (top - bottom)
    m[2, 3] = -(far + near) / (far - near)
    m[3, 3] = 1.0
    return m.to(device)
