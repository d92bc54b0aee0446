"""Differentiable splat optimization ("training") on one GPU (counterpart of
the JAX package's ``parallel/train.py``).

Parameterization (standard 3DGS training form, as the JAX package's):
  - ``log_scales``    — scales = exp(log_scales) (positivity)
  - ``logit_opacity`` — opacity = sigmoid(logit_opacity)
  - ``quats``         — unnormalized; the renderer normalizes internally
  - ``rgb``, ``sh``   — raw

A step renders the tile blocks through ``pipeline.render_tiles``, which
routes as ``render()`` does (projection, binning, kernels B1 and B2 on a
CUDA device; with ``cfg.render_mode_2d`` the surfel path, kernels B3 and
B4), takes the masked mean squared error of the tile blocks and applies
the optimizer.  The multi-GPU mesh is not ported
yet: ``mesh`` must be None.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core.types import Camera, RenderConfig, SplatData
from ..render.pipeline import render_tiles


class SplatParams(nn.Module):
    """Optimizable splat parameters, one ``nn.Parameter`` per field."""

    FIELDS = ("means", "log_scales", "quats", "rgb", "logit_opacity", "sh")

    def __init__(self, means, log_scales, quats, rgb, logit_opacity, sh):
        super().__init__()
        self.means = nn.Parameter(means)            # [N, 3]
        self.log_scales = nn.Parameter(log_scales)  # [N, 3]
        self.quats = nn.Parameter(quats)            # [N, 4]
        self.rgb = nn.Parameter(rgb)                # [N, 3]
        self.logit_opacity = nn.Parameter(logit_opacity)  # [N]
        self.sh = nn.Parameter(sh)                  # [N, K, 3]

    @property
    def num_splats(self) -> int:
        return self.means.shape[0]

    @staticmethod
    def from_splats(splats: SplatData) -> "SplatParams":
        with torch.no_grad():
            op = torch.clamp(splats.colors[:, 3], 1e-4, 1.0 - 1e-4)
            return SplatParams(
                means=splats.means.clone(),
                log_scales=torch.log(torch.clamp(splats.scales, min=1e-12)),
                quats=splats.quats.clone(),
                rgb=splats.colors[:, :3].clone(),
                logit_opacity=torch.log(op / (1.0 - op)),
                sh=splats.sh.clone())

    @staticmethod
    def from_numpy(means, log_scales, quats, rgb, logit_opacity, sh,
                   device="cuda") -> "SplatParams":
        """Float32 parameters on ``device`` from numpy-convertible arrays
        (the JAX package's ``SplatParams`` leaves, through ``np.asarray``)."""
        return SplatParams(*(torch.tensor(np.asarray(a, np.float32),
                                          device=device)
                             for a in (means, log_scales, quats, rgb,
                                       logit_opacity, sh)))

    def to_splats(self) -> SplatData:
        opacity = torch.sigmoid(self.logit_opacity)
        return SplatData(
            means=self.means,
            scales=torch.exp(self.log_scales),
            quats=self.quats,
            colors=torch.cat([self.rgb, opacity[:, None]], dim=-1),
            sh=self.sh)


def adam(lr: float):
    """``torch.optim.Adam`` with optax.adam's constants (b1 0.9, b2 0.999,
    eps 1e-8), as a factory of parameters -> optimizer."""
    return functools.partial(torch.optim.Adam, lr=lr, betas=(0.9, 0.999),
                             eps=1e-8)


@dataclass
class TrainState:
    """The parameters, the optimizer that holds their moments (None: fresh
    moments at the next step, as optax's ``init``), and the step count."""

    params: SplatParams
    opt_state: Optional[torch.optim.Optimizer]
    step: int = 0

    @staticmethod
    def create(splats: SplatData, optimizer) -> "TrainState":
        params = SplatParams.from_splats(splats)
        return TrainState(params=params,
                          opt_state=optimizer(params.parameters()), step=0)


def image_to_tile_blocks(img: torch.Tensor, cfg: RenderConfig):
    """Raster image [H, W, C] -> GL-oriented tile blocks [T, P, C] + a
    validity mask [T, P] that zeroes padded pixels beyond the viewport."""
    ts = cfg.tile_size
    h, w, c = img.shape
    if (h, w) != (cfg.height, cfg.width):
        raise ValueError(f"image {tuple(img.shape)} is not {cfg.height}x"
                         f"{cfg.width}")
    ph, pw = cfg.tiles_y * ts, cfg.tiles_x * ts
    gl = torch.zeros((ph, pw, c), dtype=img.dtype, device=img.device)
    gl[:h, :w] = img.flip(0)                         # row 0 at GL y=0
    tiles = gl.reshape(cfg.tiles_y, ts, cfg.tiles_x, ts, c)
    tiles = tiles.permute(0, 2, 1, 3, 4).reshape(-1, ts * ts, c)
    m = torch.zeros((ph, pw), dtype=torch.float32, device=img.device)
    m[:h, :w] = 1.0
    mask = m.reshape(cfg.tiles_y, ts, cfg.tiles_x, ts).permute(
        0, 2, 1, 3).reshape(-1, ts * ts)
    return tiles, mask


def tile_loss(chans: torch.Tensor, target_tiles: torch.Tensor,
              tile_mask: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """Mean squared error of composited tile blocks ``chans [T, NC + 1, P]``
    (alpha last, over ``cfg.background``) against ``target_tiles [T, P,
    3]``, over the pixels of ``tile_mask``."""
    trans = 1.0 - chans[:, -1]
    rendered = torch.stack([chans[:, c] + trans * bg
                            for c, bg in enumerate(cfg.background)], 1)
    err = (rendered - target_tiles.permute(0, 2, 1)) ** 2 * tile_mask[:, None]
    return err.sum() / (tile_mask.sum() * 3.0)


def make_train_step(cfg: RenderConfig, mesh, optimizer,
                    route: str = "gather", slab_mode: str = "banded"):
    """Build a train step on one device.

    Returns ``step(state, camera, target_tiles, tile_mask) -> (state,
    metrics)`` with target_tiles/tile_mask from :func:`image_to_tile_blocks`
    and metrics ``loss`` and ``grad_norm`` (the global norm of the
    gradients, as optax's), 0-d tensors.  The step updates ``state`` in
    place (the optimizer's own update) and returns it.  ``optimizer`` is a
    factory of parameters -> ``torch.optim.Optimizer`` (:func:`adam`); it
    builds the moments of a state that has none.  ``mesh``, ``route`` and
    ``slab_mode`` belong to the multi-GPU path, not ported yet: None and
    the defaults only.
    """
    if mesh is not None:
        raise NotImplementedError(
            "multi-GPU training (a device mesh) is not ported yet")
    if route != "gather" or slab_mode != "banded":
        raise NotImplementedError(
            f"route={route!r}, slab_mode={slab_mode!r} belong to the "
            "multi-GPU path, which is not ported yet")

    def step(state: TrainState, camera: Camera, target_tiles, tile_mask):
        params = state.params
        if state.opt_state is None:
            state.opt_state = optimizer(params.parameters())
        state.opt_state.zero_grad(set_to_none=True)
        chans, _, _ = render_tiles(params.to_splats(), camera, cfg)
        loss = tile_loss(chans, target_tiles, tile_mask, cfg)
        loss.backward()
        grads = []
        for p in params.parameters():
            if p.grad is None:       # a field the render did not reach
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        grad_norm = torch.sqrt(sum((g * g).sum() for g in grads))
        state.opt_state.step()
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return step
