"""Splat projection: 3D Gaussian -> screen-space Gaussian (EWA), counterpart
of the JAX package's ``render/projection.py`` with the same operation order,
so both packages agree to float32 rounding.

Per splat: model -> view -> clip transform with a 1.2*w clip-space cull;
3D covariance; EWA Jacobian (perspective or orthographic); 2D kernel
dilation and optional antialiasing compensation; the lambda2 > 0 cull (or
point-cloud discs); SH color; the opacity-tightened support box; the depth
key (clip-space z).  Pixel coordinates are GL-oriented (y up).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..constants import (
    CLIP_FACTOR,
    EIGENVALUE_GUARD,
    GAUSSIAN_CUTOFF,
    POINT_CLOUD_EIGENVALUE,
    SQRT8,
)
from ..core import math3d
from ..core.covariance import covariance6_elements, quadratic_form6
from ..core.sh import eval_sh_color
from ..core.types import Camera, RenderConfig, SplatData, derive_focal
from ..utils.metrics import traced


@dataclass
class ProjectedSplats:
    """Per-splat screen-space quantities, every field a flat [N] tensor.

    Culled splats have ``opacity == 0`` and ``rx == ry == 0``.
    """

    xs: torch.Tensor        # [N] pixel x (GL orientation, y up)
    ys: torch.Tensor        # [N] pixel y
    conic_a: torch.Tensor   # [N] G = a dx^2 + 2 b dx dy + c dy^2
    conic_b: torch.Tensor   # [N]
    conic_c: torch.Tensor   # [N]
    col_r: torch.Tensor     # [N] view-dependent RGB
    col_g: torch.Tensor     # [N]
    col_b: torch.Tensor     # [N]
    opacity: torch.Tensor   # [N]
    depth: torch.Tensor     # [N] clip-space z (pre-divide), +inf when culled
    rx: torch.Tensor        # [N] conservative pixel AABB half-extent x
    ry: torch.Tensor        # [N]
    mask: torch.Tensor      # [N] bool visibility

    @property
    def mean2d(self) -> torch.Tensor:
        return torch.stack([self.xs, self.ys], dim=1)

    @property
    def conic(self) -> torch.Tensor:
        return torch.stack([self.conic_a, self.conic_b, self.conic_c], dim=1)

    @property
    def color(self) -> torch.Tensor:
        return torch.stack([self.col_r, self.col_g, self.col_b], dim=1)

    @property
    def radius(self) -> torch.Tensor:
        return torch.stack([self.rx, self.ry], dim=1)


def _eval_covariance2d(a0, b0, c0, cfg: RenderConfig):
    """Dilate the 2x2 covariance; return the evaluated covariance (incl.
    splat_scale^2), the antialiasing compensation, the 1-sigma extents
    (ax, ay) and the lambda2 > 0 validity."""
    det_orig = a0 * c0 - b0 * b0
    a = a0 + cfg.kernel_2d_size
    c = c0 + cfg.kernel_2d_size
    b = b0
    det_blur = a * c - b * b
    if cfg.antialiased:
        compensation = torch.sqrt(torch.clamp(det_orig / det_blur, min=0.0))
    else:
        compensation = torch.ones_like(det_orig)

    half_trace = 0.5 * (a + c)
    term2 = torch.sqrt(torch.clamp(half_trace * half_trace - det_blur,
                                   min=EIGENVALUE_GUARD))
    lam2 = half_trace - term2
    s = cfg.splat_scale
    if cfg.point_cloud_mode:
        # Point-cloud mode overrides the eigenvalues before the lambda2
        # cull (SplatMaterial3D.js:184-188): isotropic discs, no cull.
        valid = torch.ones_like(lam2, dtype=torch.bool)
        a_eval = torch.full_like(a, POINT_CLOUD_EIGENVALUE)
        b_eval = torch.zeros_like(b)
        c_eval = torch.full_like(c, POINT_CLOUD_EIGENVALUE)
    else:
        valid = lam2 > 0.0
        a_eval, b_eval, c_eval = a, b, c
    s2 = s * s
    cov_eval = (a_eval * s2, b_eval * s2, c_eval * s2)
    ax = torch.sqrt(torch.clamp(a_eval, min=0.0)) * s
    ay = torch.sqrt(torch.clamp(c_eval, min=0.0)) * s
    return cov_eval, compensation, (ax, ay), valid


def support_radius(ax, ay, opacity, cfg: RenderConfig):
    """Flat [N] (rx, ry) support-box half-extents: the AABB of the
    G = min(8, 2 ln(opacity / min_alpha)) ellipse, clamped to the max screen
    size and quantized UP to 1/16 px (exact in binning's u16 fixed point).
    Gradient-free by contract: callers pass a detached opacity."""
    if cfg.min_alpha > 0.0:
        g_eff = torch.clamp(
            2.0 * torch.log(torch.clamp(opacity, min=cfg.min_alpha)
                            / cfg.min_alpha), 0.0, GAUSSIAN_CUTOFF)
        r_fac = torch.sqrt(g_eff)
    else:
        r_fac = SQRT8
    max_ext = cfg.max_screen_space_splat_size * cfg.splat_scale
    rx = torch.clamp(r_fac * ax, max=max_ext)
    ry = torch.clamp(r_fac * ay, max=max_ext)
    rx = torch.clamp(torch.ceil(rx * 16.0) * (1.0 / 16.0), max=4095.9375)
    ry = torch.clamp(torch.ceil(ry * 16.0) * (1.0 / 16.0), max=4095.9375)
    return rx, ry


def conic_from_cov(a, b, c):
    """Invert symmetric 2x2 covariances given as flat (a, b, c) triples."""
    det = a * c - b * b
    inv_det = torch.where(det != 0.0, 1.0 / det, torch.zeros_like(det))
    return c * inv_det, -b * inv_det, a * inv_det


@traced("gs.project")
def project_splats(splats: SplatData, camera: Camera, cfg: RenderConfig,
                   transforms: torch.Tensor | None = None,
                   scene_indices: torch.Tensor | None = None,
                   scene_opacities: torch.Tensor | None = None,
                   scene_visibility: torch.Tensor | None = None,
                   fade_params: tuple | None = None,
                   ) -> ProjectedSplats:
    """Project all splats for one camera.

    Args:
      transforms: optional ``[S, 4, 4]`` per-scene model transforms.
      scene_indices: ``[N]`` integer scene id per splat (all 0 if omitted).
      scene_opacities / scene_visibility: optional ``[S]`` per-scene opacity
        multiplier and visibility mask (need ``transforms``).
      fade_params: optional ``(scene_center [3], fade_start_radius)``: the
        reference's scene-reveal fade (SplatMaterial.js:347-363).
    """
    n = splats.num_splats
    dev = splats.device
    w, h = cfg.width, cfg.height
    focal = derive_focal(camera.proj, w, h) * cfg.focal_adjustment

    means = splats.means
    mx, my, mz = means[:, 0], means[:, 1], means[:, 2]
    if transforms is not None:
        if scene_indices is None:
            scene_ids = torch.zeros((n,), dtype=torch.long, device=dev)
        else:
            scene_ids = scene_indices.long()
        tfs = transforms.reshape(-1, 4, 4)
        mv_s = camera.view[None] @ tfs                   # [S, 4, 4] (tiny)

        def mv(i, j):
            return mv_s[:, i, j][scene_ids]

        vx = mv(0, 0) * mx + mv(0, 1) * my + mv(0, 2) * mz + mv(0, 3)
        vy = mv(1, 0) * mx + mv(1, 1) * my + mv(1, 2) * mz + mv(1, 3)
        vz = mv(2, 0) * mx + mv(2, 1) * my + mv(2, 2) * mz + mv(2, 3)
        # SH view directions in model-local space:
        # normalize(center - inverse(transform) * cameraPosition).
        inv_tf_s = torch.linalg.inv(tfs)
        local_cam_s = (inv_tf_s[:, :3, :3] @ camera.cam_pos
                       + inv_tf_s[:, :3, 3])             # [S, 3]
        dirs = math3d.normalize(means - local_cam_s[scene_ids])
        m3e = [[mv(i, j) for j in range(3)] for i in range(3)]
    else:
        scene_ids = None
        m3 = camera.view[:3, :3]
        m3e = [[m3[i, j] for j in range(3)] for i in range(3)]
        # Elementwise, not a matmul, like the JAX package (same rounding).
        vx = (m3e[0][0] * mx + m3e[0][1] * my + m3e[0][2] * mz
              + camera.view[0, 3])
        vy = (m3e[1][0] * mx + m3e[1][1] * my + m3e[1][2] * mz
              + camera.view[1, 3])
        vz = (m3e[2][0] * mx + m3e[2][1] * my + m3e[2][2] * mz
              + camera.view[2, 3])
        dirs = math3d.normalize(means - camera.cam_pos)

    pr = camera.proj
    clip_x = pr[0, 0] * vx + pr[0, 1] * vy + pr[0, 2] * vz + pr[0, 3]
    clip_y = pr[1, 0] * vx + pr[1, 1] * vy + pr[1, 2] * vz + pr[1, 3]
    clip_z = pr[2, 0] * vx + pr[2, 1] * vy + pr[2, 2] * vz + pr[2, 3]
    clip_w = pr[3, 0] * vx + pr[3, 1] * vy + pr[3, 2] * vz + pr[3, 3]
    lim = CLIP_FACTOR * clip_w
    visible = ((clip_z >= -lim) & (clip_x >= -lim) & (clip_x <= lim)
               & (clip_y >= -lim) & (clip_y <= lim))

    safe_w = torch.where(torch.abs(clip_w) < 1e-9,
                         torch.full_like(clip_w, 1e-9), clip_w)
    xs = (clip_x / safe_w + 1.0) * (0.5 * w)
    ys = (clip_y / safe_w + 1.0) * (0.5 * h)

    # --- EWA 2D covariance (flat elementwise) ---
    cov6 = covariance6_elements(splats.scales, splats.quats)
    if cfg.orthographic:
        # J = diag(fx, fy): pixels per world unit.
        u = tuple(focal[0] * m3e[0][j] for j in range(3))
        v = tuple(focal[1] * m3e[1][j] for j in range(3))
    else:
        z = torch.where(torch.abs(vz) < 1e-6, torch.full_like(vz, 1e-6), vz)
        inv_z = 1.0 / z
        j00 = focal[0] * inv_z
        j02 = -focal[0] * vx * inv_z * inv_z
        j11 = focal[1] * inv_z
        j12 = -focal[1] * vy * inv_z * inv_z
        u = tuple(j00 * m3e[0][j] + j02 * m3e[2][j] for j in range(3))
        v = tuple(j11 * m3e[1][j] + j12 * m3e[2][j] for j in range(3))

    cov_eval, compensation, (ax, ay), eig_valid = _eval_covariance2d(
        quadratic_form6(cov6, u, u), quadratic_form6(cov6, u, v),
        quadratic_form6(cov6, v, v), cfg)
    conic_a, conic_b, conic_c = conic_from_cov(*cov_eval)

    color = eval_sh_color(splats.colors[:, :3], splats.sh, dirs,
                          cfg.sh_degree)
    opacity = splats.colors[:, 3] * compensation
    if fade_params is not None:
        # Full opacity inside the fade radius, linear ramp to 0 over 0.75
        # world units past it (SplatMaterial.js:352-358).
        fade_center, fade_radius = fade_params
        center = torch.as_tensor(fade_center, dtype=torch.float32,
                                 device=dev)
        center_dist = torch.linalg.norm(means - center[None, :], dim=-1)
        ramp = 1.0 - torch.clamp((center_dist - fade_radius) / 0.75,
                                 0.0, 1.0)
        opacity = opacity * torch.where(center_dist < fade_radius,
                                        torch.ones_like(ramp), ramp)
    if scene_ids is not None and scene_opacities is not None:
        sc_op = scene_opacities[scene_ids]
        if scene_visibility is not None:
            sc_op = sc_op * scene_visibility[scene_ids].to(sc_op.dtype)
        visible = visible & (sc_op > 0.01)
        opacity = opacity * sc_op
    visible = visible & eig_valid & (opacity >= cfg.min_alpha)

    depth = torch.where(visible, clip_z, torch.full_like(clip_z, float("inf")))
    opacity = torch.where(visible, opacity, torch.zeros_like(opacity))
    rx, ry = support_radius(ax, ay, opacity.detach(), cfg)
    rx = torch.where(visible, rx, torch.zeros_like(rx))
    ry = torch.where(visible, ry, torch.zeros_like(ry))
    return ProjectedSplats(xs=xs, ys=ys,
                           conic_a=conic_a, conic_b=conic_b, conic_c=conic_c,
                           col_r=color[:, 0], col_g=color[:, 1],
                           col_b=color[:, 2],
                           opacity=opacity, depth=depth, rx=rx, ry=ry,
                           mask=visible)


def quantize_depth(depth: torch.Tensor, mask: torch.Tensor, bits: int,
                   depth_bounds: tuple | None = None) -> torch.Tensor:
    """Depth -> integer bucket like the reference sorter's range map:
    ``floor((d - min) * (nbuckets / span))``, evaluated in float32 in that
    order (any other order shifts buckets).  Invisible splats get the
    maximum bucket.  ``depth_bounds`` ``(dmin, dmax)`` (floats or 0-d
    tensors) replaces the visible splats' own range: the sharded path
    passes the globally reduced bounds so every shard buckets alike.
    Returns int64."""
    if depth_bounds is None:
        big = 3.0e38
        dmin = torch.where(mask, depth, torch.full_like(depth, big)).min()
        dmax = torch.where(mask, depth, torch.full_like(depth, -big)).max()
    else:
        dmin, dmax = (torch.as_tensor(b, dtype=torch.float32,
                                      device=depth.device)
                      for b in depth_bounds)
    span = torch.clamp(dmax - dmin, min=1e-20)
    nbuckets = (1 << bits) - 1
    safe = torch.where(mask, depth, dmin)
    # a true float32 division: `int / tensor` would be reciprocal * int
    scale = torch.div(torch.full_like(span, nbuckets), span)
    q = torch.floor((safe - dmin) * scale).long()
    q = torch.clamp(q, 0, nbuckets)
    return torch.where(mask, q, torch.full_like(q, nbuckets))
