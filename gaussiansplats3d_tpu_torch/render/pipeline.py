"""The tiled render path: project -> bin/sort -> composite -> image
(counterpart of the JAX package's ``render/pipeline.py``).

1. ``project_splats``   EWA projection + SH shading (PyTorch ops)
2. ``bin_sort_records`` pair expansion + one key sort + record gather
3. ``composite_tiles``  per-tile front-to-back compositing (kernel B1 on a
                        CUDA device, its plain version on the CPU)
4. ``assemble_image``   [T, NC + 1, P] tile blocks -> [H, W] images

The path is differentiable with respect to every ``SplatData`` field:
autograd runs the projection's and assembly's backward, the compositor's
backward is kernel B2 (its plain version on the CPU), and binning passes
each pair's cotangent to its splat (straight-through codecs, the record
gather's backward ``binning.gather_bwd``).

With ``cfg.render_mode_2d`` the 2DGS surfel mode takes the same four steps
through ``surfel.surfel_tiles``: ``project_surfels``, ``bin_sort_surfels``,
the surfel compositor (kernels B3 forward and B4 backward), then
``assemble_image``.  :func:`render_tiles` is the one place that chooses
the route; :func:`render` and the training step both call it.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.types import Camera, RenderConfig, SplatData
from ..utils.metrics import traced
from .binning import SortedPairs, bin_sort_records
from .cuda_rasterize import composite_tiles, tile_ids_from_base
from .projection import project_splats
from .surfel import surfel_tiles


def composite_sorted(cfg: RenderConfig, pairs: SortedPairs, tile_arg=0,
                     num_tiles: int | None = None) -> torch.Tensor:
    """The tile compositor over a SortedPairs record set: ``chans [T, NC +
    1, P]``, rows 0..NC-1 the record channels, row NC the alpha.
    Differentiable with respect to ``pairs.records`` (B2 backward).  The
    tiles' global ids are ``tile_arg + arange(num_tiles)`` for an int
    (the whole image from 0, or a banded slab), or ``tile_arg`` itself,
    ``[num_tiles]`` int32 (an interleaved slab); ``num_tiles`` defaults to
    the image's."""
    if cfg.return_depth and pairs.num_channels != 4:
        raise ValueError("cfg.return_depth needs pairs binned with it")
    cfg.check_backend(pairs.records.device)
    tile_ids = tile_ids_from_base(tile_arg, num_tiles or cfg.num_tiles,
                                  pairs.records.device)
    chans, _, _ = composite_tiles(cfg, pairs.records, pairs.tile_starts,
                                  pairs.tile_counts, tile_ids)
    return chans


def assemble_image(chans: torch.Tensor, cfg: RenderConfig):
    """Tile blocks [T, NC + 1, P] (alpha last) -> dict of ``color`` [H, W, 3]
    and ``alpha`` [H, W], row 0 at the top (tile pixels are GL-oriented, y
    up); with a depth channel also ``depth`` [H, W], the alpha-normalised
    mean depth, 0 where nothing was hit."""
    ts = cfg.tile_size
    ncp = chans.shape[1]
    nc = ncp - 1
    img = chans.reshape(cfg.tiles_y, cfg.tiles_x, ncp, ts, ts)
    img = img.permute(2, 0, 3, 1, 4).reshape(ncp, cfg.tiles_y * ts,
                                             cfg.tiles_x * ts)
    img = img[:, :cfg.height].flip(1)[:, :, :cfg.width]
    alpha = img[nc]
    trans = 1.0 - alpha
    # the background as Python floats: a tensor of it would be a copy to
    # the device, which waits for the device, on every render
    out = {
        "color": torch.stack([img[c] + trans * bg
                              for c, bg in enumerate(cfg.background)], -1),
        "alpha": alpha,
    }
    if nc == 4:
        depth = img[3] / torch.clamp(alpha, min=1e-6)
        out["depth"] = torch.where(alpha > 1e-6, depth,
                                   torch.zeros_like(depth))
    return out


def render_tiles(splats: SplatData, camera: Camera, cfg: RenderConfig,
                 transforms: Optional[torch.Tensor] = None,
                 scene_indices: Optional[torch.Tensor] = None,
                 scene_opacities: Optional[torch.Tensor] = None,
                 scene_visibility: Optional[torch.Tensor] = None,
                 fade_params: Optional[tuple] = None):
    """The composited tile blocks of the tiled path ``cfg`` selects:
    ``(chans [T, NC + 1, P], num_pairs, overflow)``, alpha last in
    ``chans``.  3D Gaussians (B1, B2 backward), or with
    ``cfg.render_mode_2d`` the surfels (``surfel.surfel_tiles``: B3, B4
    backward), which take no ``fade_params``, as in the JAX package."""
    cfg.check_backend(splats.device)
    if cfg.render_mode_2d:
        return surfel_tiles(splats, camera, cfg, transforms, scene_indices,
                            scene_opacities, scene_visibility)
    proj = project_splats(splats, camera, cfg, transforms, scene_indices,
                          scene_opacities, scene_visibility,
                          fade_params=fade_params)
    pairs = bin_sort_records(proj, cfg)
    return composite_sorted(cfg, pairs), pairs.total_pairs, pairs.overflow


@traced("gs.render")
def render(splats: SplatData, camera: Camera, cfg: RenderConfig,
           transforms: Optional[torch.Tensor] = None,
           scene_indices: Optional[torch.Tensor] = None,
           scene_opacities: Optional[torch.Tensor] = None,
           scene_visibility: Optional[torch.Tensor] = None,
           fade_params: Optional[tuple] = None,
           return_aux: bool = False):
    """Render one view through the tiled path (:func:`render_tiles`, then
    :func:`assemble_image`).

    Returns a dict with ``color`` [H, W, 3] and ``alpha`` [H, W]; with
    ``cfg.return_depth`` also ``depth`` [H, W]; with ``return_aux`` also
    ``num_pairs`` and ``overflow`` (aux pairs dropped), as 0-d tensors.
    The images are differentiable with respect to every ``SplatData``
    field: a backward through them runs the compositor's backward kernel
    once (B2, or B4 with ``cfg.render_mode_2d``).
    """
    chans, num_pairs, overflow = render_tiles(
        splats, camera, cfg, transforms, scene_indices, scene_opacities,
        scene_visibility, fade_params)
    out = assemble_image(chans, cfg)
    if return_aux:
        out["num_pairs"] = num_pairs
        out["overflow"] = overflow
    return out


def render_2d_tiled(splats: SplatData, camera: Camera, cfg: RenderConfig,
                    transforms: Optional[torch.Tensor] = None,
                    scene_indices: Optional[torch.Tensor] = None,
                    scene_opacities: Optional[torch.Tensor] = None,
                    scene_visibility: Optional[torch.Tensor] = None,
                    return_aux: bool = False):
    """The tiled 2DGS render whatever ``cfg.render_mode_2d`` says (the JAX
    package's ``surfel.render_2d_tiled``): :func:`render` in that mode."""
    return render(splats, camera, cfg.replace(render_mode_2d=True),
                  transforms, scene_indices, scene_opacities,
                  scene_visibility, return_aux=return_aux)


def render_batch(splats: SplatData, cameras: Camera, cfg: RenderConfig,
                 **kwargs):
    """Render a batch of cameras (leading axis on every Camera field), one
    view after another; every output gains that leading axis.
    Differentiable as :func:`render`."""
    outs = [render(splats, Camera(view=cameras.view[b],
                                  proj=cameras.proj[b],
                                  cam_pos=cameras.cam_pos[b]), cfg, **kwargs)
            for b in range(cameras.view.shape[0])]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def stack_cameras(cams) -> Camera:
    """[Camera, ...] -> one batched Camera for :func:`render_batch`."""
    return Camera(view=torch.stack([c.view for c in cams]),
                  proj=torch.stack([c.proj for c in cams]),
                  cam_pos=torch.stack([c.cam_pos for c in cams]))
