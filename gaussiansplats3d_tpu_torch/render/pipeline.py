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
each pair's cotangent to its splat (straight-through codecs, scatter-add).
The 2DGS surfel mode is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.types import Camera, RenderConfig, SplatData
from .binning import SortedPairs, bin_sort_records
from .cuda_rasterize import composite_tiles
from .projection import project_splats


def check_backend(cfg: RenderConfig, device: torch.device) -> None:
    """Raise unless ``cfg.backend`` suits tensors on ``device``: 'auto'
    suits any device ('cuda' on a CUDA device, 'torch' on the CPU), an
    explicit backend only its own.  The route itself is chosen by the
    tensors' device in ``cuda_rasterize.composite_fwd``."""
    if cfg.backend == "cuda" and device.type != "cuda":
        raise ValueError(f"backend 'cuda' needs CUDA tensors, got {device}")
    if cfg.backend == "torch" and device.type != "cpu":
        raise ValueError(f"backend 'torch' runs on CPU tensors, got {device}")


def _composite(cfg: RenderConfig, pairs: SortedPairs) -> torch.Tensor:
    tile_ids = torch.arange(cfg.num_tiles, dtype=torch.int32,
                            device=pairs.records.device)
    chans, _, _ = composite_tiles(cfg, pairs.records, pairs.tile_starts,
                                  pairs.tile_counts, tile_ids)
    return chans


def composite_sorted(cfg: RenderConfig, pairs: SortedPairs) -> torch.Tensor:
    """The tile compositor over a SortedPairs record set: ``chans [T, NC +
    1, P]``, rows 0..NC-1 the record channels, row NC the alpha.
    Differentiable with respect to ``pairs.records`` (B2 backward)."""
    if cfg.return_depth and pairs.num_channels != 4:
        raise ValueError("cfg.return_depth needs pairs binned with it")
    check_backend(cfg, pairs.records.device)
    return _composite(cfg, pairs)


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


def render(splats: SplatData, camera: Camera, cfg: RenderConfig,
           transforms: Optional[torch.Tensor] = None,
           scene_indices: Optional[torch.Tensor] = None,
           scene_opacities: Optional[torch.Tensor] = None,
           scene_visibility: Optional[torch.Tensor] = None,
           fade_params: Optional[tuple] = None,
           return_aux: bool = False):
    """Render one view through the tiled path.

    Returns a dict with ``color`` [H, W, 3] and ``alpha`` [H, W]; with
    ``cfg.return_depth`` also ``depth`` [H, W]; with ``return_aux`` also
    ``num_pairs`` and ``overflow`` (aux pairs dropped), as 0-d tensors.
    The images are differentiable with respect to every ``SplatData``
    field: a backward through them runs B1's backward, kernel B2, once.
    """
    if cfg.render_mode_2d:
        raise NotImplementedError("the 2DGS surfel mode is not ported yet")
    check_backend(cfg, splats.device)
    proj = project_splats(splats, camera, cfg, transforms, scene_indices,
                          scene_opacities, scene_visibility,
                          fade_params=fade_params)
    pairs = bin_sort_records(proj, cfg)
    out = assemble_image(_composite(cfg, pairs), cfg)
    if return_aux:
        out["num_pairs"] = pairs.total_pairs
        out["overflow"] = pairs.overflow
    return out


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
