"""Splat picking: ray vs splat intersection, fully vectorized (counterpart
of the JAX package's ``viewer/raycaster.py``).

Replaces the reference's CPU octree walk + per-leaf tests
(src/raycaster/Raycaster.js:36-165, Ray.js:26-113) with one vectorized
test over every splat, an [N]-wide computation on the splats' device.
Both of the reference's hit tests are provided:

- sphere approximation: radius = mean of the three scales ("splat-sphere",
  Raycaster.js:120-133)
- true ellipsoid: transform the ray into the splat's unit-sphere frame
  (scale/rotation inverse) and test there (:135-160).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..core import math3d
from ..core.types import Camera, SplatData


@dataclasses.dataclass
class Ray:
    origin: torch.Tensor      # [3]
    direction: torch.Tensor   # [3] normalized

    @staticmethod
    def from_camera_and_screen(camera: Camera, screen_x: float,
                               screen_y: float, width: int, height: int
                               ) -> "Ray":
        """Build a world-space ray through pixel (x, y), raster orientation
        (y down, origin top-left) like DOM mouse coordinates; float32 on
        the camera's device."""
        ndc_x = 2.0 * (screen_x + 0.5) / width - 1.0
        ndc_y = 1.0 - 2.0 * (screen_y + 0.5) / height
        inv_proj = torch.linalg.inv(camera.proj)
        inv_view = torch.linalg.inv(camera.view)
        near = inv_proj @ torch.tensor([ndc_x, ndc_y, -1.0, 1.0],
                                       device=camera.proj.device)
        near = near / near[3]
        world = inv_view @ near
        origin = camera.cam_pos
        direction = math3d.normalize(world[:3] - origin)
        return Ray(origin=origin, direction=direction)


@dataclasses.dataclass
class Hit:
    splat_index: int
    scene_index: int
    t: float                 # distance along the ray
    point: np.ndarray        # [3] world-space intersection


class Raycaster:
    """Stateless picking helper."""

    def __init__(self, ellipsoid: bool = False):
        # False = splat-sphere approximation (the reference default)
        self.ellipsoid = ellipsoid

    def intersect(self, ray: Ray, splats: SplatData,
                  transforms: Optional[torch.Tensor] = None,
                  scene_indices: Optional[torch.Tensor] = None,
                  min_alpha: float = 0.01) -> Optional[Hit]:
        t, idx = intersect_splats(ray.origin, ray.direction, splats,
                                  self.ellipsoid, transforms, scene_indices,
                                  min_alpha)
        t = float(t)
        if not math.isfinite(t):
            return None
        idx = int(idx)
        scene = int(scene_indices[idx]) if scene_indices is not None else 0
        point = (ray.origin + t * ray.direction).cpu().numpy()
        return Hit(splat_index=idx, scene_index=scene, t=t, point=point)


def intersect_splats(origin, direction, splats: SplatData,
                     ellipsoid: bool = False,
                     transforms: Optional[torch.Tensor] = None,
                     scene_indices: Optional[torch.Tensor] = None,
                     min_alpha: float = 0.01):
    """Closest-hit test. Returns (t, splat_index) as 0-d tensors on the
    splats' device; t = +inf on a miss."""
    means = splats.means
    if transforms is not None:
        if scene_indices is None:
            scene_indices = torch.zeros((means.shape[0],), dtype=torch.long,
                                        device=means.device)
        tf = transforms[scene_indices.long()]                 # [N, 4, 4]
        means = (torch.einsum("nij,nj->ni", tf[:, :3, :3], means)
                 + tf[:, :3, 3])

    visible = splats.colors[:, 3] >= min_alpha

    if not ellipsoid:
        # sphere of radius mean(scale) (Raycaster.js:120-133)
        radius = splats.scales.mean(dim=1)
        if transforms is not None:
            # approximate uniform scene scale from the transform columns
            radius = radius * torch.linalg.norm(tf[:, :3, 0], dim=1)
        t = _ray_sphere(origin, direction, means, radius)
    else:
        # unit-sphere frame test (Raycaster.js:135-160)
        rot = math3d.quat_to_rotmat(splats.quats)      # [N, 3, 3]
        if transforms is not None:
            rot = tf[:, :3, :3] @ rot
        # local = diag(1/s) R^T (p - mean)
        inv_s = 1.0 / torch.clamp(splats.scales, min=1e-9)
        rel_o = origin[None, :] - means
        o_loc = torch.einsum("nji,nj->ni", rot, rel_o) * inv_s
        d_loc = torch.einsum("nji,j->ni", rot, direction) * inv_s
        t = _ray_sphere_local(o_loc, d_loc)

    inf = torch.full_like(t, math.inf)
    t = torch.where(visible & (t >= 0), t, inf)
    best = torch.argmin(t)
    return t[best], best


# Both tests take the squared distance between the sphere's centre and the
# ray from the perpendicular offset itself.  The JAX package's
# |rel|^2 - tca^2 (and the quadratic's b^2 - 4ac) are the same quantity but
# cancel in float32 when a splat is far and small (|rel|^2 ~ 55 against
# r^2 ~ 1e-4 at 4K scene scale), and then t moves by ~1e-4 of itself with
# the summation order of the device.


def _ray_sphere(origin, direction, centers, radius):
    rel = centers - origin[None, :]
    tca = rel @ direction
    perp = rel - tca[:, None] * direction[None, :]
    d2 = torch.sum(perp * perp, dim=1)
    r2 = radius * radius
    thc = torch.sqrt(torch.clamp(r2 - d2, min=0.0))
    t0 = tca - thc
    t1 = tca + thc
    t = torch.where(t0 >= 0, t0, t1)
    return torch.where(d2 <= r2, t, torch.full_like(t, math.inf))


def _ray_sphere_local(o, d):
    """Per-splat rays o + t d vs the unit sphere at the origin. o, d:
    [N, 3]; the roots of |o + t d|^2 = 1."""
    a = torch.sum(d * d, dim=1)
    tca = -torch.sum(o * d, dim=1) / a
    perp = o + tca[:, None] * d
    d2 = torch.sum(perp * perp, dim=1)
    thc = torch.sqrt(torch.clamp(1.0 - d2, min=0.0) / a)
    t0 = tca - thc
    t1 = tca + thc
    t = torch.where(t0 >= 0, t0, t1)
    return torch.where(d2 <= 1.0, t, torch.full_like(t, math.inf))
