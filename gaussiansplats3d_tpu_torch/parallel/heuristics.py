"""Adaptive density control for splat training (densify + prune), the
counterpart of the JAX package's ``parallel/heuristics.py``.

The standard 3DGS heuristics (clone small / split large high-gradient
splats, prune transparent ones) in the JAX package's static-shape form:
the parameter arrays stay at a fixed capacity, dead splats are parked with
opacity ~ 0 (they cull in projection and bin nowhere), and each densify
step fills dead slots from a fixed budget of candidates.  Random draws come
from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..core import math3d
from .train import SplatParams

_DEAD_LOGIT = -12.0          # sigmoid ~ 6e-6: always culled


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    grad_threshold: float = 2e-4     # mean positional-grad norm trigger
    min_opacity: float = 0.005       # prune below
    percent_dense: float = 0.01      # split/clone size boundary (x extent)
    split_scale_factor: float = 1.6  # 3DGS split shrink
    budget_per_step: int = 2048      # max new splats per densify call
    scene_extent: float = 1.0


@dataclasses.dataclass
class DensifyState:
    """Accumulated positional-gradient statistics between densify calls."""

    grad_accum: torch.Tensor   # [N] sum of ||dL/dmean||
    grad_vec: torch.Tensor     # [N, 3] sum of dL/dmean (clone direction)
    count: torch.Tensor        # [N] int32 steps accumulated

    @staticmethod
    def create(n: int, device="cuda") -> "DensifyState":
        return DensifyState(
            grad_accum=torch.zeros((n,), dtype=torch.float32, device=device),
            grad_vec=torch.zeros((n, 3), dtype=torch.float32, device=device),
            count=torch.zeros((n,), dtype=torch.int32, device=device))

    def update(self, mean_grads: torch.Tensor) -> "DensifyState":
        return DensifyState(
            grad_accum=self.grad_accum + torch.linalg.norm(mean_grads, dim=-1),
            grad_vec=self.grad_vec + mean_grads,
            count=self.count + 1)


def _top_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores, the lower index first on ties (as
    ``jax.lax.top_k``; ``torch.topk`` promises no order on ties)."""
    return torch.sort(score, descending=True, stable=True).indices[:k]


@torch.no_grad()
def densify_and_prune(params: SplatParams, state: DensifyState,
                      generator: torch.Generator, cfg: DensifyConfig,
                      noise: Optional[torch.Tensor] = None,
                      ) -> Tuple[SplatParams, DensifyState]:
    """One adaptive-density step (static shapes); returns new parameters
    and a reset state.

    1. prune:  opacity < min_opacity -> dead slot
    2. candidates: mean accumulated grad norm > grad_threshold
       - clone  (scale small): copy, nudged along the gradient direction
       - split  (scale large): resample within the Gaussian, shrink scales
    3. new splats fill the lowest-opacity dead slots, at most
       ``budget_per_step`` per call.

    ``noise``: the split draws, ``[budget, 3]`` standard normals; drawn
    from ``generator`` when None.
    """
    n = params.num_splats
    dev = params.means.device
    opacity = torch.sigmoid(params.logit_opacity)
    scales = torch.exp(params.log_scales)
    max_scale = scales.amax(dim=-1)

    avg_grad = state.grad_accum / torch.clamp(state.count, min=1)
    alive = opacity >= cfg.min_opacity
    hot = alive & (avg_grad > cfg.grad_threshold)
    big = max_scale > cfg.percent_dense * cfg.scene_extent
    split_mask = hot & big

    # --- choose up to budget candidates (highest accumulated gradient) ---
    budget = min(cfg.budget_per_step, n)
    cand_score = torch.where(hot, avg_grad,
                             torch.full_like(avg_grad, -math.inf))
    src = _top_indices(cand_score, budget)
    cand_ok = hot[src]

    # --- choose destination slots: the least-opaque (prefer dead) ---
    dest = _top_indices(-opacity, budget)
    # a destination is usable only if it is dead/prunable and not itself
    # a candidate source
    use = cand_ok & (opacity[dest] < cfg.min_opacity)

    src_scales = scales[src]
    src_rot = math3d.quat_to_rotmat(params.quats[src])
    is_split = split_mask[src]

    # split: sample a point from the source Gaussian; shrink both copies.
    if noise is None:
        noise = torch.randn((budget, 3), generator=generator, device=dev)
    offset = torch.einsum("nij,nj->ni", src_rot, noise * src_scales)
    # clone: nudge the copy one step along the descent direction (the
    # average accumulated -grad), scaled to the source's extent.
    gvec = state.grad_vec[src] / torch.clamp(state.count[src], min=1)[:, None]
    gdir = gvec / torch.clamp(torch.linalg.norm(gvec, dim=-1, keepdim=True),
                              min=1e-12)
    clone_nudge = -gdir * (0.5 * src_scales.amax(dim=-1, keepdim=True))
    new_means = torch.where(is_split[:, None], params.means[src] + offset,
                            params.means[src] + clone_nudge)
    log_split = math.log(cfg.split_scale_factor)
    new_log_scales = torch.where(is_split[:, None],
                                 params.log_scales[src] - log_split,
                                 params.log_scales[src])

    def scatter_rows(arr, rows):
        mask = use.reshape((budget,) + (1,) * (arr.ndim - 1))
        out = arr.detach().clone()
        out[dest] = torch.where(mask, rows, arr[dest])
        return out

    # split sources shrink too (3DGS splits one Gaussian into two);
    # src and dest slots are disjoint (sources are alive, dests dead).
    log_scales = scatter_rows(params.log_scales, new_log_scales)
    log_scales.index_add_(0, src, torch.where(
        (use & is_split)[:, None], torch.full_like(new_log_scales, -log_split),
        torch.zeros_like(new_log_scales)))
    logit = scatter_rows(params.logit_opacity, params.logit_opacity[src])

    # --- prune: park transparent splats ---
    dead = torch.sigmoid(logit) < cfg.min_opacity
    logit = torch.where(dead, torch.full_like(logit, _DEAD_LOGIT), logit)
    new_params = SplatParams(
        means=scatter_rows(params.means, new_means),
        log_scales=log_scales,
        quats=scatter_rows(params.quats, params.quats[src]),
        rgb=scatter_rows(params.rgb, params.rgb[src]),
        logit_opacity=logit,
        sh=scatter_rows(params.sh, params.sh[src]))
    return new_params, DensifyState.create(n, device=dev)


def num_alive(params: SplatParams, min_opacity: float = 0.005
              ) -> torch.Tensor:
    return (torch.sigmoid(params.logit_opacity) >= min_opacity).sum()
