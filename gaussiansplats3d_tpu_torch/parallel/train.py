"""Differentiable splat optimization ("training") on one GPU or over a
device mesh (counterpart of the JAX package's ``parallel/train.py``).

Parameterization (standard 3DGS training form, as the JAX package's):
  - ``log_scales``    — scales = exp(log_scales) (positivity)
  - ``logit_opacity`` — opacity = sigmoid(logit_opacity)
  - ``quats``         — unnormalized; the renderer normalizes internally
  - ``rgb``, ``sh``   — raw

Without a mesh, a step renders the tile blocks through
``pipeline.render_tiles``, which routes as ``render()`` does (projection,
binning, kernels B1 and B2 on a CUDA device; with ``cfg.render_mode_2d``
the surfel path, kernels B3 and B4), takes the masked mean squared error
of the tile blocks and applies the optimizer; on a CUDA device the surfel
route's step is captured into one CUDA graph and replayed
(:class:`_StepGraph`).  With a mesh, every rank
renders its slab through ``sharded.sharded_render_tiles`` and takes the
error over its slab of the targets; the slabs' error sums are summed over
the tile group and divided by the whole mask's count (every rank holds
the whole mask), so the loss is the single-device loss.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..core.types import Camera, RenderConfig, SplatData
from ..render.pipeline import render_tiles
from ..utils import metrics
from ..utils.metrics import span, traced
from .mesh import SPLAT_AXIS, TILE_AXIS, mesh_coordinate, mesh_shape
from .sharded import interleave_tile_order, sharded_render_tiles


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


def _error_sum(chans: torch.Tensor, target_tiles: torch.Tensor,
               tile_mask: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    trans = 1.0 - chans[:, -1]
    rendered = torch.stack([chans[:, c] + trans * bg
                            for c, bg in enumerate(cfg.background)], 1)
    err = (rendered - target_tiles.permute(0, 2, 1)) ** 2 * tile_mask[:, None]
    return err.sum()


def tile_loss(chans: torch.Tensor, target_tiles: torch.Tensor,
              tile_mask: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """Mean squared error of composited tile blocks ``chans [T, NC + 1, P]``
    (alpha last, over ``cfg.background``) against ``target_tiles [T, P,
    3]``, over the pixels of ``tile_mask``."""
    return _error_sum(chans, target_tiles, tile_mask, cfg) / (
        tile_mask.sum() * 3.0)


def _grads(params: SplatParams):
    grads = []
    for p in params.parameters():
        if p.grad is None:       # a field the render did not reach
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    return grads


def make_train_step(cfg: RenderConfig, mesh, optimizer,
                    route: str = "gather", slab_mode: str = "banded",
                    exchange_capacity: Optional[int] = None):
    """Build a train step.

    Returns ``step(state, camera, target_tiles, tile_mask) -> (state,
    metrics)`` with target_tiles/tile_mask from :func:`image_to_tile_blocks`
    (the whole image's, on every rank) and metrics ``loss`` and
    ``grad_norm`` (the global norm of the gradients, as optax's), 0-d
    tensors.  The step updates ``state`` in place (the optimizer's own
    update) and returns it.  ``optimizer`` is a factory of parameters ->
    ``torch.optim.Optimizer`` (:func:`adam`); it builds the moments of a
    state that has none.

    Without a mesh, with ``cfg.render_mode_2d`` on a CUDA device, the
    second step on a state captures the step into a CUDA graph, the
    optimizer given Adam's ``capturable`` form, and later steps replay it
    (:class:`_StepGraph`); a new state, optimizer or input shape runs
    eagerly and captures again.

    With ``mesh`` (a ``mesh.make_mesh``), every rank of it calls the step
    with its own shard of the parameters (``sharded.device_put_sharded_
    splats`` with ``route``, then :meth:`TrainState.create`): the render is
    ``sharded.sharded_render_tiles`` with ``route``, ``slab_mode`` and
    ``exchange_capacity``, the loss the single-device loss.  Under
    'gather' the parameters are replicated over the tile axis and their
    gradients all-reduced over the tile group; under 'a2a' each lives on
    one rank.  ``grad_norm`` counts each parameter once; the optimizer
    steps locally.  ``route``, ``slab_mode`` and ``exchange_capacity``
    belong to the mesh.
    """
    if mesh is None:
        if (route, slab_mode, exchange_capacity) != ("gather", "banded",
                                                     None):
            raise ValueError("route, slab_mode and exchange_capacity need "
                             "a mesh")
        return _single_step(cfg, optimizer)
    return _mesh_step(cfg, mesh, optimizer, route, slab_mode,
                      exchange_capacity)


def _eager_step(cfg: RenderConfig, optimizer):
    """The single-device step's work as the host enqueues it, op by op:
    ``eager(state, camera, target_tiles, tile_mask) -> (loss, grad_norm)``,
    the state updated in place and its step count left as it was."""
    def eager(state: TrainState, camera: Camera, target_tiles, tile_mask):
        params = state.params
        if state.opt_state is None:
            state.opt_state = optimizer(params.parameters())
        state.opt_state.zero_grad(set_to_none=True)
        chans, _, _ = render_tiles(params.to_splats(), camera, cfg)
        loss = tile_loss(chans, target_tiles, tile_mask, cfg)
        with span("gs.backward"):
            loss.backward()
        grad_norm = torch.sqrt(sum((g * g).sum() for g in _grads(params)))
        state.opt_state.step()
        return loss.detach(), grad_norm

    return eager


def _single_step(cfg: RenderConfig, optimizer):
    eager = _eager_step(cfg, optimizer)
    # the surfel route's step is a chain of small kernels, each enqueued
    # by the host: on a CUDA device it is captured once and replayed
    run = _StepGraph(eager) if cfg.render_mode_2d else None

    @traced("gs.train.step")
    def step(state: TrainState, camera: Camera, target_tiles, tile_mask):
        if run is None:
            metrics.observe("train.graph.eager", 1)
            loss, grad_norm = eager(state, camera, target_tiles, tile_mask)
        else:
            loss, grad_norm = run(state, camera, target_tiles, tile_mask)
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm}

    return step


def _make_capturable(opt: torch.optim.Optimizer) -> None:
    """Give ``opt`` (``torch.optim.Adam``) the form a CUDA graph can
    capture, with the same constants: each group ``capturable``, each
    parameter's step count on the parameter's device."""
    for group in opt.param_groups:
        group["capturable"] = True
        for p in group["params"]:
            st = opt.state.get(p)
            if st and st["step"].device != p.device:
                st["step"] = st["step"].to(p.device)


def _tensor_sig(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), tuple(t.shape), t.dtype, t.device)


class _StepGraph:
    """The single-device step as one CUDA graph.

    A call whose state and inputs differ from what the last call left
    (:meth:`_sig`: the parameters and the optimizer by identity and
    storage, the optimizer's moments and constants, the inputs' shapes,
    dtypes and device; the RenderConfig is the step's own) runs ``eager``
    and drops the graph; the next call
    with the same ones captures ``eager`` into a graph and replays it, and
    every later one copies its camera and targets into the graph's
    inputs and replays.  So the first call on a state builds the
    optimizer's moments and every lazily made table and kernel library
    before a capture.  Off a CUDA device every call is eager.  A replay
    counts what the captured call counted (``metrics.Recording``); the
    counters ``train.graph.replays``, ``train.graph.captures`` and
    ``train.graph.eager`` say how the steps ran.  Returns fresh ``(loss,
    grad_norm)`` tensors on every call."""

    def __init__(self, eager):
        self.eager = eager
        self.sig = None          # what the last call left
        self.graph = self.static = self.out = self.recorded = None

    @staticmethod
    def _sig(state: TrainState, inputs: tuple):
        if state.opt_state is None or not all(t.is_cuda for t in inputs):
            return None
        opt, params = state.opt_state, state.params
        plist = list(params.parameters())
        if not all(p.is_cuda for p in plist):
            return None
        consts = tuple(
            (k, id(v) if isinstance(v, torch.Tensor) else v)
            for g in opt.param_groups for k, v in sorted(g.items())
            if k != "params")
        # the objects themselves: compared by identity, and held, so that
        # no later object takes their place unseen
        return (params, opt, consts,
                tuple(_tensor_sig(p) for p in plist),
                tuple(_tensor_sig(p) for g in opt.param_groups
                      for p in g["params"]),
                tuple(_tensor_sig(t) for st in opt.state.values()
                      for t in st.values() if isinstance(t, torch.Tensor)),
                tuple((tuple(t.shape), t.dtype, t.device) for t in inputs))

    def __call__(self, state: TrainState, camera: Camera, target_tiles,
                 tile_mask):
        inputs = (camera.view, camera.proj, camera.cam_pos, target_tiles,
                  tile_mask)
        sig = self._sig(state, inputs)
        if sig is None or sig != self.sig:
            # the graph and every buffer of its memory pool go
            self.graph = self.static = self.out = self.recorded = None
            metrics.observe("train.graph.eager", 1)
            out = self.eager(state, camera, target_tiles, tile_mask)
            self.sig = self._sig(state, inputs)
            return out
        if self.graph is None:
            self._capture(state, inputs)
        else:
            for dst, src in zip(self.static, inputs):
                dst.copy_(src)
        self.graph.replay()
        self.recorded.replay()
        metrics.observe("train.graph.replays", 1)
        return tuple(t.clone() for t in self.out)

    def _capture(self, state: TrainState, inputs: tuple) -> None:
        _make_capturable(state.opt_state)
        self.static = [t.clone() for t in inputs]
        view, proj, cam_pos, tiles, mask = self.static
        state.opt_state.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        with metrics.recording() as rec, torch.cuda.graph(graph):
            self.out = self.eager(state, Camera(view=view, proj=proj,
                                                cam_pos=cam_pos),
                                  tiles, mask)
        self.graph, self.recorded = graph, rec
        self.sig = self._sig(state, inputs)
        metrics.observe("train.graph.captures", 1)


def _mesh_step(cfg: RenderConfig, mesh, optimizer, route: str,
               slab_mode: str, exchange_capacity: Optional[int]):
    _, t = mesh_shape(mesh)
    _, j = mesh_coordinate(mesh)
    tile_group = mesh.get_group(TILE_AXIS)
    # the groups whose ranks hold different parameters
    norm_groups = [mesh.get_group(SPLAT_AXIS)] + (
        [tile_group] if route == "a2a" else [])

    @traced("gs.train.step")
    def step(state: TrainState, camera: Camera, target_tiles, tile_mask):
        params = state.params
        if state.opt_state is None:
            state.opt_state = optimizer(params.parameters())
        state.opt_state.zero_grad(set_to_none=True)
        chans = sharded_render_tiles(
            mesh, params.to_splats(), camera, cfg,
            exchange_capacity=exchange_capacity, route=route,
            slab_mode=slab_mode)
        if slab_mode == "interleaved":
            target_tiles = interleave_tile_order(target_tiles, t,
                                                 cfg.tiles_x)
            tile_mask = interleave_tile_order(tile_mask, t, cfg.tiles_x)
        lt = chans.shape[0]
        mine = slice(j * lt, (j + 1) * lt)
        den = tile_mask.sum() * 3.0
        num = _error_sum(chans, target_tiles[mine], tile_mask[mine], cfg)
        # d(loss)/d(this slab) is that of num / den; the loss sums the
        # slabs' numerators
        with span("gs.backward"):
            (num / den).backward()
        loss = num.detach().reshape(1).clone()
        dist.all_reduce(loss, group=tile_group)
        sq = sum((g * g).sum() for g in _grads(params)).reshape(1)
        for group in norm_groups:
            dist.all_reduce(sq, group=group)
        state.opt_state.step()
        state.step += 1
        return state, {"loss": loss[0] / den, "grad_norm": torch.sqrt(sq[0])}

    return step
