"""The 2DGS "surfel" render mode (counterpart of the JAX package's
``render/surfel.py``; the reference's SplatMaterial2D).

Each splat is a flat disk in its tangent plane: L = R diag(s) with only the
first two columns used.  ``T = splat2world^T world2ndc ndc2pix`` maps
homogeneous tangent coordinates (u, v, 1) to homogeneous pixel coordinates;
its columns are GLSL's Tu, Tv, Tw.  Screen box: distance = |Tw|^2 under
(1, 1, -1), the center and 1-sigma extents from the homography, support 3
sigma, on a 1/16-px grid.  Per fragment (the kernels in
``cuda_surfel.py``): k = px Tw - Tu, l = py Tw - Tv, p = k x l, s = p.xy /
p.z; rho = min(|s|^2, 2 |pix - center|^2); depth = s . Tw.xy + Tw.z (Tw.z
when the screen-space term wins) must be >= 0.2; alpha = min(0.99,
opacity exp(-rho / 2)), cut below min_alpha and outside the box.

Two paths share :func:`project_surfels`: :func:`render_2d` composites
globally depth-sorted surfels over every pixel (the small-scene oracle),
:func:`surfel_tiles` bins them into per-tile records
(:func:`bin_sort_surfels`) and composites them with kernel B3 (its backward
B4) on a CUDA device, their plain versions on the CPU; ``pipeline.render``
takes that route with ``cfg.render_mode_2d``.  The 2D path takes
no ``fade_params``, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..constants import CLIP_FACTOR
from ..core import math3d
from ..core.sh import eval_sh_color
from ..core.types import Camera, RenderConfig, SplatData
from ..utils.metrics import traced
from .binning import expand_sort, f16_round, slab_window, u16r_round
from .compositing import pixel_grid
from .cuda_rasterize import tile_ids_from_base
from .cuda_surfel import composite_surfel_tiles, surfel_alpha
from .projection import quantize_depth

# Surfels a step of the oracle composites over every pixel (the JAX
# package's default cfg.chunk_size).
ORACLE_CHUNK = 128


@dataclass
class SurfelProjection:
    """Flat per-surfel screen-space quantities.

    ``t`` holds the row-major 3x3 homography as 9 [N] tensors (t00 t01 t02
    t10 ... t22; Tu/Tv/Tw are its columns); mean2d and radius give the
    binning box.  Culled surfels have opacity 0, radius 0 and depth +inf.
    """

    t: tuple                 # 9 x [N]
    mean2d: torch.Tensor     # [N, 2] center2d
    radius: torch.Tensor     # [N, 2] support half-extents (1/16-px grid)
    color: torch.Tensor      # [N, 3]
    opacity: torch.Tensor    # [N]
    depth: torch.Tensor      # [N]
    mask: torch.Tensor       # [N] bool

    @property
    def xs(self) -> torch.Tensor:
        return self.mean2d[:, 0]

    @property
    def ys(self) -> torch.Tensor:
        return self.mean2d[:, 1]

    @property
    def rx(self) -> torch.Tensor:
        return self.radius[:, 0]

    @property
    def ry(self) -> torch.Tensor:
        return self.radius[:, 1]


def _to_pixels(m: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """``m^T ndc2pix`` for ``[..., 4, 4]`` clip matrices: ``[..., 4, 3]``.
    ndc2pix = [[W/2, 0, 0], [0, H/2, 0], [0, 0, 0], [W/2, H/2, 1]], written
    out with Python floats, and rounded as the JAX package's product is on
    the CPU: the row-3 term is fused onto the row-0 (row-1) product, one
    rounding (taken in float64, where the product is exact); the zero terms
    add nothing."""
    def fused(r, scale):
        return (r * scale).double().add(m[..., 3, :].double() * scale).to(
            m.dtype)

    return torch.stack([fused(m[..., 0, :], w / 2.0),
                        fused(m[..., 1, :], h / 2.0), m[..., 3, :]], dim=-1)


@traced("gs.project")
def project_surfels(splats: SplatData, camera: Camera, cfg: RenderConfig,
                    transforms: torch.Tensor | None = None,
                    scene_indices: torch.Tensor | None = None,
                    scene_opacities: torch.Tensor | None = None,
                    scene_visibility: torch.Tensor | None = None
                    ) -> SurfelProjection:
    """Elementwise surfel projection: every per-splat quantity is a flat
    [N] expression; the 4x4 algebra happens once per scene.

    Args as ``projection.project_splats`` (``transforms [S, 4, 4]``,
    ``scene_indices [N]``, ``scene_opacities`` / ``scene_visibility
    [S]``).  The divisions are guarded (``1 / where(ok, distance, 1)``,
    ``sqrt(max(1e-4, .))``) so that autograd never meets 0/0.
    """
    n = splats.num_splats
    w, h = cfg.width, cfg.height
    means = splats.means
    mx, my, mz = means[:, 0], means[:, 1], means[:, 2]

    if transforms is not None:
        if scene_indices is None:
            scene_ids = torch.zeros((n,), dtype=torch.long,
                                    device=splats.device)
        else:
            scene_ids = scene_indices.long()
        tfs = transforms.reshape(-1, 4, 4)
        mv_s = camera.view[None] @ tfs                        # [S, 4, 4]
        b_s = _to_pixels(camera.proj @ mv_s, w, h)            # [S, 4, 3]

        def bb(i, j):
            return b_s[:, i, j][scene_ids]

        def mv(i, j):
            return mv_s[:, i, j][scene_ids]

        inv_tf_s = torch.linalg.inv(tfs)
        local_cam_s = (inv_tf_s[:, :3, :3] @ camera.cam_pos
                       + inv_tf_s[:, :3, 3])
        dirs = math3d.normalize(means - local_cam_s[scene_ids])
    else:
        scene_ids = None
        mv1 = camera.view
        b1 = _to_pixels(camera.proj @ mv1, w, h)              # [4, 3]

        def bb(i, j):
            return b1[i, j]

        def mv(i, j):
            return mv1[i, j]

        dirs = math3d.normalize(means - camera.cam_pos)

    # view-space center + clip cull (elementwise, as the 3D path)
    vx = mv(0, 0) * mx + mv(0, 1) * my + mv(0, 2) * mz + mv(0, 3)
    vy = mv(1, 0) * mx + mv(1, 1) * my + mv(1, 2) * mz + mv(1, 3)
    vz = mv(2, 0) * mx + mv(2, 1) * my + mv(2, 2) * mz + mv(2, 3)
    pr = camera.proj
    clip_z = pr[2, 0] * vx + pr[2, 1] * vy + pr[2, 2] * vz + pr[2, 3]
    clip_x = pr[0, 0] * vx + pr[0, 1] * vy + pr[0, 2] * vz + pr[0, 3]
    clip_y = pr[1, 0] * vx + pr[1, 1] * vy + pr[1, 2] * vz + pr[1, 3]
    clip_w = pr[3, 0] * vx + pr[3, 1] * vy + pr[3, 2] * vz + pr[3, 3]
    lim = CLIP_FACTOR * clip_w
    visible = ((clip_z >= -lim) & (clip_x >= -lim) & (clip_x <= lim)
               & (clip_y >= -lim) & (clip_y <= lim))

    # L = R S columns 0 and 1, elementwise quaternion algebra
    q = splats.quats
    qn = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                         min=1e-12)
    qx, qy, qz, qw = qn[:, 0], qn[:, 1], qn[:, 2], qn[:, 3]
    s0, s1 = splats.scales[:, 0], splats.scales[:, 1]
    l0x = (1 - 2 * (qy * qy + qz * qz)) * s0
    l0y = (2 * (qx * qy + qw * qz)) * s0
    l0z = (2 * (qx * qz - qw * qy)) * s0
    l1x = (2 * (qx * qy - qw * qz)) * s1
    l1y = (1 - 2 * (qx * qx + qz * qz)) * s1
    l1z = (2 * (qy * qz + qw * qx)) * s1

    # t[i][j] = a_i . B[:, j]; rows of a: (l0, 0), (l1, 0), (mean, 1)
    t_rows = []
    for (ax, ay, az, homog) in ((l0x, l0y, l0z, False),
                                (l1x, l1y, l1z, False),
                                (mx, my, mz, True)):
        for j in range(3):
            v = ax * bb(0, j) + ay * bb(1, j) + az * bb(2, j)
            if homog:
                v = v + bb(3, j)
            t_rows.append(v)
    (t00, t01, t02, t10, t11, t12, t20, t21, t22) = t_rows

    # screen box from the homography (SplatMaterial2D.js:165-187)
    distance = t02 * t02 + t12 * t12 - t22 * t22
    ok = torch.abs(distance) >= 1e-5
    inv_d = 1.0 / torch.where(ok, distance, torch.ones_like(distance))
    f0, f1, f2 = inv_d, inv_d, -inv_d
    cx = f0 * t00 * t02 + f1 * t10 * t12 + f2 * t20 * t22
    cy = f0 * t01 * t02 + f1 * t11 * t12 + f2 * t21 * t22
    tmp_x = f0 * t00 * t00 + f1 * t10 * t10 + f2 * t20 * t20
    tmp_y = f0 * t01 * t01 + f1 * t11 * t11 + f2 * t21 * t21
    ext_x = torch.sqrt(torch.clamp(cx * cx - tmp_x, min=1e-4))
    ext_y = torch.sqrt(torch.clamp(cy * cy - tmp_y, min=1e-4))
    s = cfg.splat_scale
    max_ext = float(cfg.max_screen_space_splat_size)
    rx = torch.clamp(3.0 * ext_x * s, max=max_ext)
    ry = torch.clamp(3.0 * ext_y * s, max=max_ext)
    # ceil to the 1/16-px grid: exact in the u16 radius codec, lossless for
    # the hard cutoff
    rx = torch.clamp(torch.ceil(rx * 16.0) * (1.0 / 16.0), max=4095.9375)
    ry = torch.clamp(torch.ceil(ry * 16.0) * (1.0 / 16.0), max=4095.9375)

    color = eval_sh_color(splats.colors[:, :3], splats.sh, dirs,
                          cfg.sh_degree)
    opacity = splats.colors[:, 3]
    if scene_ids is not None and scene_opacities is not None:
        sc_op = scene_opacities[scene_ids]
        if scene_visibility is not None:
            sc_op = sc_op * scene_visibility[scene_ids].to(sc_op.dtype)
        visible = visible & (sc_op > 0.01)
        opacity = opacity * sc_op

    mask = visible & ok & (opacity >= cfg.min_alpha)
    zeros = torch.zeros_like(opacity)
    depth = torch.where(mask, clip_z, torch.full_like(clip_z, float("inf")))
    opacity = torch.where(mask, opacity, zeros)
    rx = torch.where(mask, rx, zeros)
    ry = torch.where(mask, ry, zeros)
    return SurfelProjection(
        t=(t00, t01, t02, t10, t11, t12, t20, t21, t22),
        mean2d=torch.stack([cx, cy], dim=1),
        radius=torch.stack([rx, ry], dim=1),
        color=color, opacity=opacity, depth=depth, mask=mask)


def _channels(sp: SurfelProjection, cfg: RenderConfig) -> list:
    """The record channels: rgb and, with ``cfg.return_depth``, the depth
    (0 on culled surfels, which carry +inf)."""
    chans = [sp.color[:, 0], sp.color[:, 1], sp.color[:, 2]]
    if cfg.return_depth:
        chans.append(torch.where(sp.mask, sp.depth,
                                 torch.zeros_like(sp.depth)))
    return chans


def render_2d(splats: SplatData, camera: Camera, cfg: RenderConfig,
              transforms: torch.Tensor | None = None,
              scene_indices: torch.Tensor | None = None,
              scene_opacities: torch.Tensor | None = None,
              scene_visibility: torch.Tensor | None = None):
    """Full-image 2DGS render: surfels globally depth-sorted (stable, on
    the tiled path's quantized key) and composited over every pixel,
    ``ORACLE_CHUNK`` at a time.  The tiled path's oracle: it shares the
    projection, so the support box is bit-identical.  O(N * P)."""
    sp = project_surfels(splats, camera, cfg, transforms, scene_indices,
                         scene_opacities, scene_visibility)
    color = torch.stack(_channels(sp, cfg), dim=-1)              # [N, NC]
    key = quantize_depth(sp.depth, sp.mask, cfg.sort_bits)
    order = torch.argsort(key, stable=True)
    t_rows = [t[order] for t in sp.t]
    center, radius = sp.mean2d[order], sp.radius[order]
    color, opacity = color[order], sp.opacity[order]

    px, py = pixel_grid(cfg.width, cfg.height, splats.device)
    p = px.shape[0]
    nc = color.shape[-1]
    color_acc = torch.zeros((p, nc), dtype=torch.float32, device=px.device)
    trans = torch.ones((p,), dtype=torch.float32, device=px.device)
    for s in range(0, color.shape[0], ORACLE_CHUNK):
        e = s + ORACLE_CHUNK

        def col(v):
            return v[s:e, None]

        alpha = surfel_alpha([col(t) for t in t_rows], col(center[:, 0]),
                             col(center[:, 1]), col(opacity),
                             col(radius[:, 0]), col(radius[:, 1]),
                             px[None], py[None], cfg.min_alpha)  # [C, P]
        logw = torch.log1p(-alpha)
        excl = torch.cumsum(logw, dim=0) - logw
        wgt = alpha * torch.exp(excl) * trans[None, :]
        color_acc = color_acc + wgt.T @ color[s:e]
        trans = trans * torch.exp(torch.sum(logw, dim=0))

    bg = torch.as_tensor(cfg.background, dtype=torch.float32,
                         device=px.device)
    alpha_img = 1.0 - trans
    out = {
        "color": (color_acc[:, :3] + trans[:, None] * bg[None, :]
                  ).reshape(cfg.height, cfg.width, 3),
        "alpha": alpha_img.reshape(cfg.height, cfg.width),
    }
    if cfg.return_depth:
        depth = color_acc[:, 3] / torch.clamp(alpha_img, min=1e-6)
        out["depth"] = torch.where(alpha_img > 1e-6, depth,
                                   torch.zeros_like(depth)).reshape(
            cfg.height, cfg.width)
    return out


@traced("gs.bin")
def bin_sort_surfels(sp: SurfelProjection, cfg: RenderConfig,
                     tile_range: tuple | None = None,
                     depth_bounds: tuple | None = None,
                     aux_capacity: int | None = None,
                     row_window: tuple | None = None):
    """Expand surfels into depth-sorted per-tile records.

    Returns ``(records [NC + 14, S], tile_starts, tile_counts, total,
    overflow)``.  Records are field-major float32: T row-major (rows 0-8),
    center x, y (9, 10), the NC channels (11..), opacity (11 + NC, 0 at
    every slot outside the tiles' windows), rx, ry (12 + NC, 13 + NC).

    Ties break by slot id whatever ``cfg.forward_only`` says, as the JAX
    package's surfel sort.  The rects come from the unquantised center and
    radii.  Under ``mixed`` and ``packed`` the rgb channels and the opacity
    are rounded through float16 (straight-through); T, the center and the
    depth channel stay exact, and rx/ry go through the u16 1/16-px codec,
    which is exact on their grid.  Gradients pass straight through to every
    row but rx/ry (detached), in float32.  ``tile_range``, ``row_window``,
    ``depth_bounds`` and ``aux_capacity`` are the sharded path's slab
    arguments, as in ``binning.bin_sort_records``.
    """
    bounds, num_tiles, tile_lo = slab_window(cfg, tile_range, row_window)
    rx, ry = sp.rx.detach(), sp.ry.detach()
    tx0, tx1, ty0, ty1, counts = bounds(sp.xs.detach(), sp.ys.detach(), rx,
                                        ry, sp.mask)
    depth_q = quantize_depth(sp.depth, sp.mask, cfg.sort_bits, depth_bounds)
    chans = _channels(sp, cfg)
    opa = sp.opacity
    if cfg.record_precision != "f32":
        chans = [f16_round(c) for c in chans[:3]] + chans[3:]
        opa = f16_round(opa)
    fields = list(sp.t) + [sp.xs, sp.ys] + chans + [opa, u16r_round(rx),
                                                    u16r_round(ry)]
    return expand_sort(cfg, tx0, ty0, tx1 - tx0 + 1, ty1 - ty0 + 1, counts,
                       depth_q, fields, opa_row=11 + len(chans),
                       carry_slot=True, num_tiles=num_tiles, tile_lo=tile_lo,
                       aux_capacity=aux_capacity)


def composite_surfels_sorted(cfg: RenderConfig, records, tile_starts,
                             tile_counts, tile_base=0,
                             num_tiles: int | None = None):
    """The surfel tile compositor over :func:`bin_sort_surfels`' records:
    ``(tile_colors [T, P, NC], tile_logtrans [T, P])``, differentiable with
    respect to ``records`` (kernel B4 backward on a CUDA device).  The
    tiles' global ids (their pixel placement) are ``tile_base + arange(
    num_tiles)`` for an int ``tile_base`` (the whole image, or a banded
    slab), or ``tile_base`` itself as a ``[num_tiles]`` int32 tensor (an
    interleaved slab); ``num_tiles`` defaults to the image's."""
    if cfg.return_depth != (records.shape[0] == 18):
        raise ValueError("cfg.return_depth needs records binned with it")
    cfg.check_backend(records.device)
    tile_ids = tile_ids_from_base(tile_base, num_tiles or cfg.num_tiles,
                                  records.device)
    colors, logt, _ = composite_surfel_tiles(cfg, records, tile_starts,
                                             tile_counts, tile_ids)
    return colors, logt


def chans_from_colors_logt(colors: torch.Tensor, logt: torch.Tensor):
    """(colors [T, P, NC], logt [T, P]) -> chans [T, NC + 1, P], alpha
    last, with alpha = 1 - exp(logt): the surfel compositor's outputs in
    the layout ``pipeline.assemble_image`` takes (so a loss on the alpha
    reaches the compositor through its logt)."""
    alpha = 1.0 - torch.exp(logt)
    return torch.cat([colors.permute(0, 2, 1), alpha[:, None]], dim=1)


def surfel_tiles(splats: SplatData, camera: Camera, cfg: RenderConfig,
                 transforms: torch.Tensor | None = None,
                 scene_indices: torch.Tensor | None = None,
                 scene_opacities: torch.Tensor | None = None,
                 scene_visibility: torch.Tensor | None = None):
    """The tiled 2DGS path up to the tile blocks: project, bin, composite
    (B3).  Returns ``(chans [T, NC + 1, P], num_pairs, overflow)``."""
    sp = project_surfels(splats, camera, cfg, transforms, scene_indices,
                         scene_opacities, scene_visibility)
    records, starts, counts, total, overflow = bin_sort_surfels(sp, cfg)
    colors, logt = composite_surfels_sorted(cfg, records, starts, counts)
    return chans_from_colors_logt(colors, logt), total, overflow
