"""Surfel tile compositor, forward and backward: the hand-written CUDA
kernels B3 and B4, their plain PyTorch versions, and the launch counters
(counterpart of the JAX package's ``render/pallas_surfel.py``).

**B3 replaces** ``gaussiansplats3d_tpu/render/pallas_surfel.py::_fwd`` and
**B4** ``::_bwd``.  Sources ``csrc/surfel_fwd.cu`` and ``csrc/surfel_bwd.cu``;
both include ``csrc/surfel_fragment.cuh``, the ray-plane fragment, written
with round-to-nearest intrinsics (no FMA contraction), so B4 rebuilds each
chunk's log-transmittance sum bit for bit as B3 computed it.  They are B1
and B2 with the 2DGS fragment in place of the Gaussian one:

    k = px Tw - Tu,  l = py Tw - Tv,  p = k x l,  s = p.xy / p.z
    rho = min(|s|^2, 2 |pix - center|^2)
    alpha = min(opacity exp(-rho / 2), 0.99), 0 where |p.z| < 1e-12, the
            depth s . Tw.xy + Tw.z (Tw.z when the 2D term wins) < 0.2,
            alpha < min_alpha, or the pixel lies outside the rx/ry box

B3, in B1's layout: one block per tile of up to 512 threads, each holding
2 pixels, a warp on an 8 x 8 patch (``cuda_rasterize.WARP_PATCH``), for
sides up to 32, and for sides 33-64 a thread-block cluster of 4 such
blocks, one a 32 x 32 quadrant, voting on the tile's exit through
distributed shared memory, and for sides of 65 or more one block that
walks the tile's 32 x 32 sub-tiles as B1 does (``csrc/warp_cull.cuh``: the
walk), so every side >= 1 launches; the tile's records staged 128 at a
time in shared memory, floor-aligned 128-pair chunk windows, each chunk
culled per warp (``csrc/warp_cull.cuh``) and the kept pairs walked in
order, T kept as a product, log T as the sum of ``max(chunk_log,
CS_FLOOR)``, the tile stops once every pixel's T is at most 1e-4.  Outputs
colors ``[T, P, NC]``, logt ``[T, P]`` and exit_k ``[T]``.  B4: chunks
``exit_k - 1 .. 0`` in reverse, each culled per warp as in B3, T_i in log
space from B3's residual log T (B3's chunk sum replayed only where T may
have died), the suffix of w cg, ``d_alpha = T cg - S / (1 - alpha) - glogt
/ (1 - alpha)`` (the image's alpha is ``1 - exp(logt)``, so glogt is
nonzero whenever a loss sees the background), then the hand-derived
transpose through the fragment to the 9 T entries, the center, the
channels and the opacity, summed over the warp by one reduce-scatter and
over the block in shared memory (at sides 33-64 the cluster's 4 blocks add
their sums through distributed shared memory, each block 32 of the chunk's
lanes; above 64 the block replays each sub-tile in turn and adds its sums
into the slots).  B3 and B4 hold the same pixels, as B1 and B2 do.

**What bounds them on the H100.**  As B1/B2: each pair may be evaluated
at every pixel of its tile until the tile exits, and each record is read
once per tile: arithmetic, not memory.  Both walk only the pairs whose box
reaches a warp's patch, and the box test comes first and rejects most
visits before the fragment's division and ``exp``.

**Plain versions** (:func:`composite_surfel_fwd_torch`,
:func:`composite_surfel_bwd_torch`): B3/B4's semantics (not the XLA
compositor ``rasterize_surfel.py``, which has no exit and a -80 floor over
the whole tile), evaluated on the in-box pair-pixel entries only, in
``cuda_rasterize``'s chunk loops.  The plain B4 takes the fragment's chain
from ``torch.autograd`` of :func:`surfel_alpha`, so the card holds the
kernel's hand-derived transpose against a machine-derived one.  The
wrappers use them for CPU tensors only; for CUDA tensors they launch the
kernels or raise.
"""

from __future__ import annotations

import torch

from ..core.types import RenderConfig
from ..utils import metrics
from . import launch
from .cuda_rasterize import CHUNK  # noqa: F401  (the records' chunk)
from .cuda_rasterize import (CS_FLOOR, EXIT_T, FWD_ARGTYPES, box_entries,
                             check_inputs, composite_bwd_chunks_torch,
                             composite_chunks_torch)
from .launch import F32, I64, INT, PTR, check_cuda_launch

ALPHA_MAX = 0.99
NEAR_N = 0.2
RECORD_ROWS = (17, 18)          # NC + 14 for NC = 3 (rgb) or 4 (+ depth)

LAUNCHES = "b3.launches"
"""The counter (``utils.metrics``) of the launches of the CUDA kernel B3
made by :func:`composite_surfel_fwd`."""
BWD_LAUNCHES = "b4.launches"
"""The counter of the launches of the CUDA kernel B4 made by
:func:`composite_surfel_bwd`."""


def reset_launches() -> None:
    metrics.reset(LAUNCHES, BWD_LAUNCHES)


_B3 = launch.Kernel("surfel_fwd", "surfel_fwd", FWD_ARGTYPES, LAUNCHES)
_B4 = launch.Kernel("surfel_bwd", "surfel_bwd",
                    (PTR, I64, INT) + (PTR,) * 7 + (INT,) * 3 + (F32,) * 2
                    + (PTR,) * 2, BWD_LAUNCHES)


def surfel_alpha(t, cx, cy, opa, rx, ry, px, py, min_alpha):
    """The surfel fragment's alpha, broadcasting the record fields (``t``:
    the 9 row-major T entries; center, opacity, rx, ry) against the pixel
    centers ``px``, ``py`` — the arithmetic of ``surfel_fragment.cuh`` and
    of the JAX package's ``_surfel_chunk_alpha``.  Differentiable in T, the
    center and the opacity; 0 (and no gradient) where culled."""
    t00, t01, t02, t10, t11, t12, t20, t21, t22 = t
    k0 = px * t02 - t00
    k1 = px * t12 - t10
    k2 = px * t22 - t20
    l0 = py * t02 - t01
    l1 = py * t12 - t11
    l2 = py * t22 - t21
    p0 = k1 * l2 - k2 * l1
    p1 = k2 * l0 - k0 * l2
    p2 = k0 * l1 - k1 * l0
    tiny = torch.abs(p2) < 1e-12
    sp2 = torch.where(tiny, torch.full_like(p2, 1e-12), p2)
    su = p0 / sp2
    sv = p1 / sp2
    rho3d = su * su + sv * sv
    dx = px - cx
    dy = py - cy
    rho2d = 2.0 * (dx * dx + dy * dy)
    use3d = rho3d <= rho2d
    rho = torch.where(use3d, rho3d, rho2d)
    depth = torch.where(use3d, su * t02 + sv * t12 + t22, t22)
    alpha = torch.clamp(opa * torch.exp(-0.5 * rho), max=ALPHA_MAX)
    bad = (tiny | (depth < NEAR_N) | (alpha < min_alpha)
           | (torch.abs(dx) > rx) | (torch.abs(dy) > ry))
    return torch.where(bad, torch.zeros_like(alpha), alpha)


def composite_surfel_fwd_cuda(records, tile_starts, tile_counts, tile_ids,
                              cfg: RenderConfig):
    """Launch B3 on the current stream.  Inputs as
    :func:`composite_surfel_fwd`, all on one CUDA device."""
    check_inputs(records, tile_starts, tile_counts, tile_ids, cfg,
                 RECORD_ROWS)
    check_cuda_launch(records, "composite_surfel_fwd_cuda")
    nf, s = records.shape
    nc = nf - 14
    t = tile_starts.shape[0]
    p = cfg.tile_size * cfg.tile_size
    dev = records.device
    colors = torch.empty((t, p, nc), dtype=torch.float32, device=dev)
    logt = torch.empty((t, p), dtype=torch.float32, device=dev)
    exit_k = torch.empty((t,), dtype=torch.int32, device=dev)
    _B3(dev, records.data_ptr(), s, nc, tile_starts.data_ptr(),
        tile_counts.data_ptr(), tile_ids.data_ptr(), t, cfg.tile_size,
        cfg.tiles_x, cfg.min_alpha, CS_FLOOR, EXIT_T, colors.data_ptr(),
        logt.data_ptr(), exit_k.data_ptr())
    return colors, logt, exit_k


def _surfel_entries(rec, window, x0, y0, nc, cfg: RenderConfig):
    """``cuda_rasterize.box_entries`` of the surfel records, with their
    ``alpha`` (:func:`surfel_alpha`)."""
    ent = box_entries(rec, window, x0, y0, 9, 12 + nc, cfg)
    r = ent["rec"]
    ent["alpha"] = surfel_alpha(r[:9], r[9], r[10], r[11 + nc], r[12 + nc],
                                r[13 + nc], ent["px"], ent["py"],
                                cfg.min_alpha)
    return ent


def composite_surfel_fwd_torch(records, tile_starts, tile_counts, tile_ids,
                               cfg: RenderConfig):
    """The plain PyTorch version of B3, on any device: B1's chunk loop
    (``cuda_rasterize.composite_chunks_torch``) over the surfel fragment's
    in-box entries."""
    check_inputs(records, tile_starts, tile_counts, tile_ids, cfg,
                 RECORD_ROWS)
    nc = records.shape[0] - 14
    chans, logt, exit_k = composite_chunks_torch(
        records, tile_starts, tile_counts, tile_ids, cfg, nc, 11,
        _surfel_entries)
    return chans[:, :nc].permute(0, 2, 1).contiguous(), logt, exit_k


def composite_surfel_fwd(records, tile_starts, tile_counts, tile_ids,
                         cfg: RenderConfig):
    """B3 on the device the tensors lie on: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.

    Args:
      records: ``[NC + 14, S]`` float32 field-major surfel records
        (``surfel.bin_sort_surfels``: T row-major, center x/y, the NC
        channels, opacity, rx, ry), S a multiple of 128.
      tile_starts / tile_counts: ``[T]`` int32 pair windows per tile.
      tile_ids: ``[T]`` int32 global tile ids (pixel placement).

    Returns ``(colors [T, P, NC], logt [T, P], exit_k [T] int32)``: the
    composited channels, the per-chunk-clamped log transmittance and the
    chunks composited.
    """
    return launch.dispatch(records, composite_surfel_fwd_cuda,
                           composite_surfel_fwd_torch)(
        records, tile_starts, tile_counts, tile_ids, cfg)


def _check_bwd(records, starts, counts, ids, logt, exit_k, gcol, glogt,
               cfg: RenderConfig):
    t, p = starts.shape[0], cfg.tile_size * cfg.tile_size
    check_inputs(records, starts, counts, ids, cfg, RECORD_ROWS, (
        ("logt", logt, (t, p), torch.float32),
        ("exit_k", exit_k, (t,), torch.int32),
        ("gcol", gcol, (t, p, records.shape[0] - 14), torch.float32),
        ("glogt", glogt, (t, p), torch.float32)))


def composite_surfel_bwd_cuda(records, tile_starts, tile_counts, tile_ids,
                              logt, exit_k, gcol, glogt, cfg: RenderConfig):
    """Launch B4 on the current stream.  Inputs as
    :func:`composite_surfel_bwd`, all on one CUDA device."""
    _check_bwd(records, tile_starts, tile_counts, tile_ids, logt, exit_k,
               gcol, glogt, cfg)
    check_cuda_launch(records, "composite_surfel_bwd_cuda")
    nf, s = records.shape
    dev = records.device
    # slots outside every window and chunks past exit_k stay 0
    grad = torch.zeros((nf, s), dtype=torch.float32, device=dev)
    _B4(dev, records.data_ptr(), s, nf - 14, tile_starts.data_ptr(),
        tile_counts.data_ptr(), tile_ids.data_ptr(), logt.data_ptr(),
        exit_k.data_ptr(), gcol.data_ptr(), glogt.data_ptr(),
        tile_starts.shape[0], cfg.tile_size, cfg.tiles_x, cfg.min_alpha,
        CS_FLOOR, grad.data_ptr())
    return grad


def composite_surfel_bwd_torch(records, tile_starts, tile_counts, tile_ids,
                               logt, exit_k, gcol, glogt,
                               cfg: RenderConfig):
    """The plain PyTorch version of B4, on any device: the reverse replay
    of chunks ``exit_k - 1 .. 0`` on B3's semantics
    (``cuda_rasterize.composite_bwd_chunks_torch``, with the glogt term),
    over the same in-box entries as :func:`composite_surfel_fwd_torch`;
    the fragment's chain is ``torch.autograd`` of :func:`surfel_alpha`."""
    _check_bwd(records, tile_starts, tile_counts, tile_ids, logt, exit_k,
               gcol, glogt, cfg)
    nc = records.shape[0] - 14
    nd = nc + 12                  # rows with a gradient: all but rx, ry

    def chain(ent, d_alpha, gate, w, gch):
        r = ent["rec"]
        # the fragment's chain, machine-derived
        with torch.enable_grad():
            rg = r[:nd].detach().requires_grad_(True)
            alpha_g = surfel_alpha(rg[:9], rg[9], rg[10], rg[11 + nc],
                                   r[12 + nc], r[13 + nc], ent["px"],
                                   ent["py"], cfg.min_alpha)
            (terms,) = torch.autograd.grad(alpha_g, rg, d_alpha)
        terms[11:11 + nc] += w * gch[:, ent["seg"]]
        return terms

    return composite_bwd_chunks_torch(
        records, tile_starts, tile_counts, tile_ids, logt, exit_k,
        gcol.flatten(0, 1).T, glogt, cfg, nc, 11, ALPHA_MAX,
        _surfel_entries, chain)


def composite_surfel_bwd(records, tile_starts, tile_counts, tile_ids, logt,
                         exit_k, gcol, glogt, cfg: RenderConfig):
    """B4 on the device the tensors lie on: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.

    Args: B3's inputs and residuals (``records``, ``tile_starts``,
    ``tile_counts``, ``tile_ids``, ``logt [T, P]``, ``exit_k [T]``), and
    the cotangents ``gcol [T, P, NC]`` of B3's colors and ``glogt [T, P]``
    of its logt.

    Returns ``grad_records [NC + 14, S]`` in the record layout: T, the
    center, the NC channels and the opacity; rx = ry = 0, and 0 at every
    slot outside the tiles' windows or in chunks past ``exit_k``.
    """
    return launch.dispatch(records, composite_surfel_bwd_cuda,
                           composite_surfel_bwd_torch)(
        records, tile_starts, tile_counts, tile_ids, logt, exit_k, gcol,
        glogt, cfg)


class _CompositeSurfelTiles(torch.autograd.Function):
    """Autograd boundary of the surfel compositor: B3 forward, B4 backward.
    Both cotangents reach B4: the image's alpha is ``1 - exp(logt)``."""

    @staticmethod
    def forward(ctx, records, tile_starts, tile_counts, tile_ids, cfg):
        colors, logt, exit_k = composite_surfel_fwd(
            records, tile_starts, tile_counts, tile_ids, cfg)
        ctx.mark_non_differentiable(exit_k)
        ctx.save_for_backward(records, tile_starts, tile_counts, tile_ids,
                              logt, exit_k)
        ctx.cfg = cfg
        return colors, logt, exit_k

    @staticmethod
    def backward(ctx, gcol, glogt, _gexit):
        with metrics.span("gs.composite.bwd"):
            grad = composite_surfel_bwd(
                *ctx.saved_tensors, gcol.to(torch.float32).contiguous(),
                glogt.to(torch.float32).contiguous(), ctx.cfg)
        return grad, None, None, None, None


def composite_surfel_tiles(cfg: RenderConfig, records, tile_starts,
                           tile_counts, tile_ids):
    """The surfel compositor as the render path calls it: ``(colors, logt,
    exit_k)`` of :func:`composite_surfel_fwd` behind a
    ``torch.autograd.Function`` whose backward is
    :func:`composite_surfel_bwd` (kernel B4 on a CUDA device, its plain
    version on the CPU)."""
    return _CompositeSurfelTiles.apply(records, tile_starts, tile_counts,
                                       tile_ids, cfg)
