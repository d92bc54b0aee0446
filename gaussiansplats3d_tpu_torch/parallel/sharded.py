"""The sharded render over a ``(splat, tile)`` mesh of torch.distributed
ranks (counterpart of the JAX package's ``parallel/sharded.py``).

Every rank calls the same functions with its own shard (SPMD), which is
what ``shard_map`` does for the JAX package:

- **splat axis**: each rank projects and shades its contiguous shard of
  splats.  The sort keys' depth bounds are a MIN/MAX all-reduce over the
  splat group (over the whole mesh for ``route='a2a'``), so every shard
  buckets depth alike.
- **exchange**: each rank keeps the projected records whose screen box
  touches its tile slab (:func:`touch_rows`), compacts them stably into a
  fixed capacity ``ecap`` and all-gathers the compacted rows over the
  splat group in one stacked collective (:class:`_RoutedExchange`); with
  ``route='a2a'`` an all-to-all over the tile group first routes one
  block per slab (:class:`_RoutedExchangeA2A`).  Rows beyond ``ecap`` are
  dropped and counted in ``overflow``.  The wire carries the float32
  record rows; binning applies the precision's codecs after the exchange
  (the JAX package packs them before its wire, and its codecs are
  idempotent, so both bin the same values).  The backward sends the
  position rows' cotangents in float32 and the rest rounded to bfloat16
  (the JAX package's wire rounding, part of the gradient it computes),
  reduce-scatters them over the splat group (and all-to-alls them back
  under ``a2a``), and scatter-adds them to their source rows.  The
  forward runs inside the span ``gs.exchange``, the backward inside
  ``gs.exchange.bwd``; while a profiler records, each call observes the
  counters ``exchange.calls``, ``exchange.kept`` (rows carried),
  ``exchange.slots`` (the slots they fill, ``ecap`` a block) and
  ``exchange.dropped`` (rows past ``ecap``).
- **tile axis**: each rank bins, sorts and composites its slab from the
  gathered rows (:func:`render_slab`) with the slab's global tile ids,
  through the same kernels as the single-device render (B1/B2, or B3/B4
  in 2D).

Replicas: the ranks of a splat group gather the same rows and compute the
same slab, so the exchange's backward averages their cotangents (the
reduce-scatter's sum over ``splat_shards`` copies, divided by their
number: ``shard_map``'s transpose divides an unmapped output's cotangent
so).  Under ``route='gather'`` the splats are replicated over the tile
axis, so their gradients are all-reduced over the tile group
(:class:`_ReplicatedOverTile`, the transpose of that replication; span
``gs.allreduce``).

Slabs: ``banded`` gives slab j the tile rows [j r, (j + 1) r); with
``interleaved`` slab j owns rows {j, j + t, ...} and its tiles come in
slab-major order (:func:`deinterleave_tile_order` restores image order).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..core.types import Camera, RenderConfig, SplatData
from ..render.binning import (_tile_of, bin_sort_records, px_round,
                              px_scale_for, rad_round_u8, strided_row_range)
from ..render.pipeline import assemble_image, composite_sorted
from ..render.projection import ProjectedSplats, project_splats
from ..render.surfel import (SurfelProjection, bin_sort_surfels,
                             chans_from_colors_logt,
                             composite_surfels_sorted, project_surfels)
from ..utils import metrics
from .mesh import (SPLAT_AXIS, TILE_AXIS, mesh_coordinate, mesh_device,
                   mesh_shape)

_BIG = 3.0e38
ROUTES = ("gather", "a2a")
SLAB_MODES = ("banded", "interleaved")


def _tile_rows_per_shard(cfg: RenderConfig, tile_shards: int) -> int:
    if cfg.tiles_y % tile_shards != 0:
        raise ValueError(
            f"tiles_y ({cfg.tiles_y}) must divide evenly across "
            f"{tile_shards} tile shards; pad the viewport height to a "
            f"multiple of {cfg.tile_size * tile_shards}")
    return cfg.tiles_y // tile_shards


def default_exchange_capacity(cfg: RenderConfig, n_local: int,
                              tile_shards: int, alpha: float = 3.0) -> int:
    """Per-(splat shard, slab) record capacity of the routed exchange: a
    shard holds ~n_local / tile_shards of the records touching one slab
    in a balanced scene; ``alpha`` is the margin (a record straddling
    slabs counts once per slab).  A multiple of 128, at least 256."""
    cap = max(256, int(alpha * n_local / max(tile_shards, 1)))
    return -(-cap // 128) * 128


def interleave_tile_order(x: torch.Tensor, t_shards: int, tiles_x: int
                          ) -> torch.Tensor:
    """Row-major tile blocks -> interleaved-slab order (slab j owns rows
    {j, j + t, ...}; order (j, r, tx))."""
    rows_per = x.shape[0] // tiles_x // t_shards
    y = x.reshape((rows_per, t_shards, tiles_x) + tuple(x.shape[1:]))
    return y.transpose(0, 1).reshape(x.shape)


def deinterleave_tile_order(x: torch.Tensor, t_shards: int, tiles_x: int
                            ) -> torch.Tensor:
    """The inverse of :func:`interleave_tile_order`."""
    rows_per = x.shape[0] // tiles_x // t_shards
    y = x.reshape((t_shards, rows_per, tiles_x) + tuple(x.shape[1:]))
    return y.transpose(0, 1).reshape(x.shape)


def exchange_plan(cfg: RenderConfig):
    """(rows on the wire, differentiable prefix, exact-cotangent rows).

    Row order, 3D: x, y, conic a, b, c, r, g, b, opacity, depth, rx, ry;
    the first 9 rows are differentiable (10 with ``cfg.return_depth``:
    depth then feeds the depth channel), the radii are plumbing.  2D: the
    nine homography entries, x, y, r, g, b, opacity, depth, rx, ry (15 or
    16 differentiable).  The exact rows (the centre's x and y, the
    densification signal) ride the backward wire in float32, the rest in
    bfloat16."""
    if cfg.render_mode_2d:
        return 18, (16 if cfg.return_depth else 15), (9, 10)
    return 12, (10 if cfg.return_depth else 9), (0, 1)


def exchange_rows(cfg: RenderConfig, proj) -> list:
    """The [N] record rows a rank routes, in :func:`exchange_plan`'s
    order."""
    depth = proj.depth if cfg.return_depth else proj.depth.detach()
    rx, ry = proj.rx.detach(), proj.ry.detach()
    if cfg.render_mode_2d:
        return list(proj.t) + [proj.xs, proj.ys, proj.color[:, 0],
                               proj.color[:, 1], proj.color[:, 2],
                               proj.opacity, depth, rx, ry]
    return [proj.xs, proj.ys, proj.conic_a, proj.conic_b, proj.conic_c,
            proj.col_r, proj.col_g, proj.col_b, proj.opacity, depth, rx, ry]


def touch_rows(cfg: RenderConfig, proj, slab: int, t_shards: int,
               slab_mode: str) -> torch.Tensor:
    """[N] bool: the visible records whose screen box touches tile slab
    ``slab`` of ``t_shards``.

    Under ``packed`` (3D) the test reads the decoded radius and the
    quantised y that binning's rects read (``rad_round_u8``,
    ``px_round``): the radius codec only grows the box and the position
    codec moves it by up to 1/scale px, so a filter on the raw values
    could drop a splat whose binned box reaches the slab's first row.
    Interleaved slabs use ``strided_row_range``, binning's own
    arithmetic, unclipped, so the filter is a superset of the window."""
    rows = _tile_rows_per_shard(cfg, t_shards)
    y, ry = proj.ys.detach(), proj.ry.detach()
    if cfg.record_precision == "packed" and not cfg.render_mode_2d:
        ry = rad_round_u8(ry)
        y = px_round(y, px_scale_for(cfg))
    ty0, ty1 = _tile_of(y - ry, cfg), _tile_of(y + ry, cfg)
    if slab_mode == "interleaved":
        lo, hi = strided_row_range(ty0, ty1, slab, t_shards)
        return proj.mask & (hi >= lo) & (hi >= 0) & (lo < rows)
    return proj.mask & (ty1 >= slab * rows) & (ty0 < (slab + 1) * rows)


def compact_rows(rows: torch.Tensor, keep: torch.Tensor, ecap: int):
    """Stable compaction of the kept columns of ``rows [F, N]`` into
    ``ecap`` slots: ``(block [F, ecap], src [ecap] int64, n_keep 0-d
    int64)``; slots past ``n_keep`` hold 0.  A stable sort of the drop
    flags keeps the kept rows in input order and waits for nothing on the
    host.  The src of a slot past ``n_keep`` is a row it does not carry,
    a different one for each slot as far as N allows: the backward adds
    those slots' (zero) cotangents there, and slots that all named one row
    would serialise on its address."""
    n = keep.shape[0]
    order = torch.sort((~keep).to(torch.int8), stable=True).indices
    if n >= ecap:
        src = order[:ecap]
    else:
        src = torch.cat([order, torch.arange(ecap - n, device=keep.device)
                         % max(n, 1)])
    n_keep = keep.sum()
    ok = torch.arange(ecap, device=keep.device) < n_keep
    block = torch.where(ok, rows[:, src], torch.zeros((), device=rows.device))
    return block.contiguous(), src, n_keep


def _all_gather(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """``[size, *x.shape]``: every rank's ``x`` of ``group`` (gathered
    along dim 0, the form both gloo and NCCL take)."""
    out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out.view((size,) + tuple(x.shape))


def slab_rows(cfg: RenderConfig, proj, slab: int, t_shards: int,
              slab_mode: str, ecap: int):
    """``(rows [F, ecap], valid [ecap])``: the rows one splat shard routes
    to slab ``slab`` of ``t_shards``, compacted as the exchange's forward
    compacts them (detached) -- what a one-shard splat group gathers, for
    :func:`render_slab` on one device."""
    rows = torch.stack(exchange_rows(cfg, proj)).detach()
    block, _, n_keep = compact_rows(
        rows, touch_rows(cfg, proj, slab, t_shards, slab_mode), ecap)
    return block, torch.arange(ecap, device=rows.device) < n_keep


@dataclass(frozen=True)
class _Wire:
    """What the exchange's autograd functions need besides tensors."""

    ecap: int
    n_diff: int
    exact: tuple
    splat_group: object
    splat_shards: int
    tile_group: object = None
    tile_shards: int = 1

    def split(self, g: torch.Tensor):
        """The cotangent rows of the differentiable prefix, averaged over
        the splat group's replicas: (exact rows float32, rest bfloat16)."""
        g = g[:self.n_diff].to(torch.float32) / self.splat_shards
        exact = [i for i in self.exact if i < self.n_diff]
        rest = [i for i in range(self.n_diff) if i not in exact]
        return exact, rest, g[exact], g[rest].to(torch.bfloat16)

    def reduce_scatter(self, ct: torch.Tensor, lead: tuple):
        """Sum ``ct [E, s * prod(lead) * ecap]`` over the splat group onto
        each rank's own block: ``[*lead, E, ecap]``."""
        e = ct.shape[0]
        s = self.splat_shards
        ct = ct.reshape((e, s) + lead + (self.ecap,))
        ct = ct.movedim(0, -2).contiguous()          # [s, *lead, E, ecap]
        out = ct.new_empty(ct.shape[1:])
        dist.reduce_scatter_tensor(out.view(-1, self.ecap),
                                   ct.view(-1, self.ecap),
                                   group=self.splat_group)
        return out


def _scatter_back(d: torch.Tensor, exact, rest, my32, my16, src, n_keep):
    """Add one block's cotangents ``my32 [E, ecap]``, ``my16 [R, ecap]``
    into ``d [n_diff, N]`` at their source rows; the slots past ``n_keep``
    are masked to 0 before the scatter."""
    full = my32.new_zeros((d.shape[0], my32.shape[1]))
    full[exact] = my32
    full[rest] = my16.to(torch.float32)
    ok = torch.arange(full.shape[1], device=full.device) < n_keep
    full = torch.where(ok, full, torch.zeros((), device=full.device))
    d.index_add_(1, src, full)


def _observe(n_keep, slots: int, dropped) -> None:
    """The exchange's counters of one forward call, while a profiler
    records: ``n_keep`` rows routed (a count per block), ``dropped`` of
    them past the capacity, into ``slots`` slots."""
    if metrics.tracing():
        metrics.observe("exchange.calls", 1)
        metrics.observe("exchange.kept", n_keep.sum() - dropped)
        metrics.observe("exchange.slots", slots)
        metrics.observe("exchange.dropped", dropped)


def _grads_of(ctx, d: torch.Tensor, n_fields: int):
    return (None, None) + tuple(
        d[i] if i < d.shape[0] and ctx.needs_input_grad[2 + i] else None
        for i in range(n_fields))


class _RoutedExchange(torch.autograd.Function):
    """The gather route: compact the kept rows to ``ecap`` slots and
    all-gather them over the splat group as one stacked float32 operand.
    Returns ``(rows [F, s * ecap], valid [s * ecap] bool, dropped)``; the
    valid mask is rebuilt from the gathered keep counts."""

    @staticmethod
    @metrics.traced("gs.exchange")
    def forward(ctx, wire: _Wire, keep, *fields):
        rows = torch.stack(fields)
        block, src, n_keep = compact_rows(rows, keep, wire.ecap)
        s = wire.splat_shards
        gathered = _all_gather(block, wire.splat_group, s)
        nk_g = _all_gather(n_keep.reshape(1), wire.splat_group, s)
        out = gathered.permute(1, 0, 2).reshape(rows.shape[0], -1)
        slot = torch.arange(wire.ecap, device=keep.device)
        valid = (slot[None] < nk_g).reshape(-1)
        dropped = torch.clamp(n_keep - wire.ecap, min=0)
        _observe(n_keep, wire.ecap, dropped)
        ctx.mark_non_differentiable(valid, dropped)
        ctx.save_for_backward(src, n_keep)
        ctx.wire, ctx.n = wire, keep.shape[0]
        return out, valid, dropped

    @staticmethod
    @metrics.traced("gs.exchange.bwd")
    def backward(ctx, g, _gvalid, _gdropped):
        wire = ctx.wire
        src, n_keep = ctx.saved_tensors
        exact, rest, g32, g16 = wire.split(g)
        my32 = wire.reduce_scatter(g32, ())
        my16 = wire.reduce_scatter(g16, ())
        d = g.new_zeros((wire.n_diff, ctx.n), dtype=torch.float32)
        _scatter_back(d, exact, rest, my32, my16, src, n_keep)
        return _grads_of(ctx, d, g.shape[0])


class _RoutedExchangeA2A(torch.autograd.Function):
    """The a2a route (splats sharded over the whole mesh): one compacted
    block per slab, an all-to-all over the tile group so that rank (i, j)
    holds the slab-j blocks its tile group built, then the splat group's
    stacked all-gather.  Returns ``(rows [F, s * t * ecap], valid,
    dropped)``.  The backward retraces both hops and accumulates the
    cotangents over slabs (a record straddling slabs gets each one's)."""

    @staticmethod
    @metrics.traced("gs.exchange")
    def forward(ctx, wire: _Wire, touch_all, *fields):
        rows = torch.stack(fields)
        t = wire.tile_shards
        parts = [compact_rows(rows, touch_all[j], wire.ecap)
                 for j in range(t)]
        send = torch.stack([p[0] for p in parts])          # [t, F, ecap]
        nk = torch.stack([p[2] for p in parts])            # [t]
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=wire.tile_group)
        nk_r = torch.empty_like(nk)
        dist.all_to_all_single(nk_r, nk, group=wire.tile_group)
        s = wire.splat_shards
        gathered = _all_gather(recv, wire.splat_group, s)
        nk_g = _all_gather(nk_r, wire.splat_group, s)
        out = gathered.permute(2, 0, 1, 3).reshape(rows.shape[0], -1)
        slot = torch.arange(wire.ecap, device=rows.device)
        valid = (slot[None] < nk_g.reshape(-1, 1)).reshape(-1)
        dropped = torch.clamp(nk - wire.ecap, min=0).sum()
        _observe(nk, t * wire.ecap, dropped)
        ctx.mark_non_differentiable(valid, dropped)
        ctx.save_for_backward(torch.stack([p[1] for p in parts]), nk)
        ctx.wire, ctx.n = wire, touch_all.shape[1]
        return out, valid, dropped

    @staticmethod
    @metrics.traced("gs.exchange.bwd")
    def backward(ctx, g, _gvalid, _gdropped):
        wire = ctx.wire
        srcs, nk = ctx.saved_tensors
        t = wire.tile_shards
        exact, rest, g32, g16 = wire.split(g)
        back = []
        for ct in (g32, g16):
            mine = wire.reduce_scatter(ct, (t,))           # [t, E, ecap]
            ret = torch.empty_like(mine)
            dist.all_to_all_single(ret, mine, group=wire.tile_group)
            back.append(ret)
        d = g.new_zeros((wire.n_diff, ctx.n), dtype=torch.float32)
        for j in range(t):
            _scatter_back(d, exact, rest, back[0][j], back[1][j], srcs[j],
                          nk[j])
        return _grads_of(ctx, d, g.shape[0])


class _ReplicatedOverTile(torch.autograd.Function):
    """Identity forward on the splat fields; backward all-reduces their
    gradients over the tile group, where ``route='gather'`` replicates
    them (one collective for all fields)."""

    @staticmethod
    def forward(ctx, group, *fields):
        ctx.group = group
        ctx.shapes = [f.shape for f in fields]
        return tuple(f.view_as(f) for f in fields)

    @staticmethod
    @metrics.traced("gs.allreduce")
    def backward(ctx, *grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=ctx.group)
        out, k = [], 0
        for shape in ctx.shapes:
            m = shape.numel()
            out.append(flat[k:k + m].view(shape))
            k += m
        return (None, *out)


class _GatherTiles(torch.autograd.Function):
    """All-gather every slab's chans over the tile group; the backward
    keeps this rank's slice of the cotangent (every rank of the group
    holds the same image and takes the same loss of it)."""

    @staticmethod
    def forward(ctx, chans, group, tile_shards: int, slab: int):
        out = _all_gather(chans, group, tile_shards)
        ctx.lo, ctx.lt = slab * chans.shape[0], chans.shape[0]
        return out.reshape((-1,) + tuple(chans.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        return g[ctx.lo:ctx.lo + ctx.lt], None, None, None


class Slab(NamedTuple):
    """One slab's binning and composite (:func:`render_slab`)."""

    chans: torch.Tensor         # [local_tiles, NC + 1, P]
    records: torch.Tensor       # the compositor's records [NF, S]
    tile_starts: torch.Tensor   # [local_tiles] int32
    tile_counts: torch.Tensor   # [local_tiles] int32
    tile_ids: torch.Tensor      # [local_tiles] int32 global tile ids
    total_pairs: torch.Tensor   # [] pairs before the aux capacity
    overflow: torch.Tensor      # [] aux pairs dropped


def slab_tile_ids(cfg: RenderConfig, slab: int, t_shards: int,
                  slab_mode: str, device) -> torch.Tensor:
    """[local_tiles] int32 global tile ids of slab ``slab`` of
    ``t_shards``: a band of rows, or rows {slab, slab + t, ...}."""
    rows = _tile_rows_per_shard(cfg, t_shards)
    lt = rows * cfg.tiles_x
    loc = torch.arange(lt, dtype=torch.int32, device=device)
    if slab_mode == "interleaved":
        return ((slab + loc // cfg.tiles_x * t_shards) * cfg.tiles_x
                + loc % cfg.tiles_x)
    return slab * lt + loc


def render_slab(cfg: RenderConfig, rows: torch.Tensor, valid: torch.Tensor,
                slab: int, t_shards: int, slab_mode: str,
                depth_bounds: tuple) -> Slab:
    """Bin and composite slab ``slab`` of ``t_shards`` from exchanged
    record rows ``rows [F, M]`` (:func:`exchange_plan`'s order; columns
    where ``valid`` is False hold no record), with the global
    ``depth_bounds``: the part of a rank's step after the exchange.
    Differentiable with respect to ``rows`` (B2, or B4 in 2D)."""
    if slab_mode not in SLAB_MODES:
        raise ValueError(f"slab_mode must be one of {SLAB_MODES}, got "
                         f"{slab_mode!r}")
    n_rows = _tile_rows_per_shard(cfg, t_shards)
    lt = n_rows * cfg.tiles_x
    tile_ids = slab_tile_ids(cfg, slab, t_shards, slab_mode, rows.device)
    if slab_mode == "interleaved":
        window = dict(row_window=(slab, t_shards, n_rows))
    else:
        window = dict(tile_range=(slab * lt, lt))
    zero = torch.zeros((), device=rows.device)
    if cfg.render_mode_2d:
        sp = SurfelProjection(
            t=tuple(rows[:9]), mean2d=rows[9:11].T, radius=rows[16:18].T,
            color=rows[11:14].T, opacity=torch.where(valid, rows[14], zero),
            depth=torch.where(valid, rows[15], zero + _BIG), mask=valid)
        recs, starts, counts, total, ovf = bin_sort_surfels(
            sp, cfg, depth_bounds=depth_bounds, **window)
        colors, logt = composite_surfels_sorted(cfg, recs, starts, counts,
                                                tile_ids, lt)
        return Slab(chans_from_colors_logt(colors, logt), recs, starts,
                    counts, tile_ids, total, ovf)
    proj = ProjectedSplats(
        xs=rows[0], ys=rows[1], conic_a=rows[2], conic_b=rows[3],
        conic_c=rows[4], col_r=rows[5], col_g=rows[6], col_b=rows[7],
        opacity=torch.where(valid, rows[8], zero),
        depth=torch.where(valid, rows[9], zero + _BIG),
        rx=rows[10], ry=rows[11], mask=valid)
    pairs = bin_sort_records(proj, cfg, depth_bounds=depth_bounds, **window)
    chans = composite_sorted(cfg, pairs, tile_ids, lt)
    return Slab(chans, pairs.records, pairs.tile_starts, pairs.tile_counts,
                tile_ids, pairs.total_pairs, pairs.overflow)


def _depth_bounds(proj, mesh, route: str):
    """Global (dmin, dmax) of the visible depths: one MAX all-reduce of
    (-min, max) over the splat group, and over the tile group too under
    ``a2a`` (the splats are sharded over both)."""
    d = proj.depth.detach()
    big = torch.full_like(d, _BIG)
    b = torch.stack([-torch.where(proj.mask, d, big).min(),
                     torch.where(proj.mask, d, -big).max()])
    dist.all_reduce(b, op=dist.ReduceOp.MAX, group=mesh.get_group(SPLAT_AXIS))
    if route == "a2a":
        dist.all_reduce(b, op=dist.ReduceOp.MAX,
                        group=mesh.get_group(TILE_AXIS))
    return -b[0], b[1]


def slab_pass(mesh, splats: SplatData, camera: Camera, cfg: RenderConfig,
              transforms: Optional[torch.Tensor] = None,
              scene_indices: Optional[torch.Tensor] = None,
              scene_opacities: Optional[torch.Tensor] = None,
              scene_visibility: Optional[torch.Tensor] = None,
              exchange_capacity: Optional[int] = None,
              route: str = "gather", slab_mode: str = "banded"):
    """A rank's render up to its slab, as :func:`sharded_render_tiles`
    takes it (the same arguments): the projection of its shard, the depth
    bounds, the routed exchange and :func:`render_slab`.  Returns
    ``(proj, slab, dropped, ecap)``: the shard's projection, the
    :class:`Slab`, the exchange's rows past ``ecap`` (per splat shard and
    slab) and the capacity taken.  A collective: every rank calls it."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if slab_mode not in SLAB_MODES:
        raise ValueError(f"slab_mode must be one of {SLAB_MODES}, got "
                         f"{slab_mode!r}")
    cfg.check_backend(splats.device)
    s, t = mesh_shape(mesh)
    _, j = mesh_coordinate(mesh)
    _tile_rows_per_shard(cfg, t)
    if exchange_capacity is None:
        # a rect over r rows touches min(r, t) round-robin slabs against
        # ~ceil(r / rows) + 1 bands, so interleaving takes a wider margin
        alpha = 4.0 if slab_mode == "interleaved" else 3.0
        exchange_capacity = default_exchange_capacity(
            cfg, splats.num_splats, t, alpha=alpha)
    ecap = exchange_capacity
    splat_group = mesh.get_group(SPLAT_AXIS)
    tile_group = mesh.get_group(TILE_AXIS)
    if route == "gather" and t > 1:
        splats = SplatData(*_ReplicatedOverTile.apply(
            tile_group, splats.means, splats.scales, splats.quats,
            splats.colors, splats.sh))
    project = project_surfels if cfg.render_mode_2d else project_splats
    proj = project(splats, camera, cfg, transforms, scene_indices,
                   scene_opacities, scene_visibility)
    dmin, dmax = _depth_bounds(proj, mesh, route)
    _, n_diff, exact = exchange_plan(cfg)
    wire = _Wire(ecap, n_diff, exact, splat_group, s, tile_group, t)
    fields = exchange_rows(cfg, proj)
    if route == "a2a":
        touch = torch.stack([touch_rows(cfg, proj, k, t, slab_mode)
                             for k in range(t)])
        rows, valid, dropped = _RoutedExchangeA2A.apply(wire, touch, *fields)
    else:
        touch = touch_rows(cfg, proj, j, t, slab_mode)
        rows, valid, dropped = _RoutedExchange.apply(wire, touch, *fields)
    slab = render_slab(cfg, rows, valid, j, t, slab_mode, (dmin, dmax))
    return proj, slab, dropped, ecap


def sharded_render_tiles(mesh, splats: SplatData, camera: Camera,
                         cfg: RenderConfig,
                         transforms: Optional[torch.Tensor] = None,
                         scene_indices: Optional[torch.Tensor] = None,
                         scene_opacities: Optional[torch.Tensor] = None,
                         scene_visibility: Optional[torch.Tensor] = None,
                         exchange_capacity: Optional[int] = None,
                         return_overflow: bool = False,
                         return_stats: bool = False,
                         route: str = "gather",
                         slab_mode: str = "banded"):
    """This rank's tile slab of the render over ``mesh``.

    Every rank of the mesh calls this with its own shard: ``splats`` (and
    ``scene_indices``) as :func:`device_put_sharded_splats` (and
    :func:`local_rows`) place them for ``route``; the camera and the
    per-scene ``transforms``, ``scene_opacities`` and ``scene_visibility``
    are the same on every rank.

    ``route``: 'gather' shards the splats over the splat axis (the tile
    axis replicates them and their projection); 'a2a' shards them over the
    whole mesh and routes records with an all-to-all first.  ``slab_mode``:
    'banded' or 'interleaved' (the chans then come in slab-major order).
    ``exchange_capacity`` defaults to :func:`default_exchange_capacity`
    (alpha 3, 4 under 'interleaved').  The slab itself is
    :func:`slab_pass`'s.

    Returns ``chans [local_tiles, NC + 1, P]`` (alpha last), and with
    ``return_overflow`` the overflow (exchange drops summed over the mesh
    plus each slab's pair drops, summed over the slabs), or with
    ``return_stats`` a dict: ``overflow``, ``slab_pairs`` ([tile_shards]
    pairs of each slab; 0 in 2D, as the JAX package reports),
    ``exchange_capacity``, ``gathered_records`` (rows each rank bins),
    ``exchange_wire_ops`` (float32 rows on the forward wire) and the
    forward and backward wire megabytes per rank.
    """
    _, slab, dropped, ecap = slab_pass(
        mesh, splats, camera, cfg, transforms, scene_indices,
        scene_opacities, scene_visibility, exchange_capacity, route,
        slab_mode)
    s, t = mesh_shape(mesh)
    splat_group = mesh.get_group(SPLAT_AXIS)
    tile_group = mesh.get_group(TILE_AXIS)

    # dropped is per (splat shard, slab): summed over both axes; the pair
    # drops are computed from the gathered rows, the same on every rank of
    # a splat group, so they are summed over the tile group only
    overflow = dropped.to(torch.int64).reshape(1).clone()
    dist.all_reduce(overflow, group=splat_group)
    overflow = overflow + slab.overflow.to(torch.int64)
    dist.all_reduce(overflow, group=tile_group)
    overflow = overflow[0]
    if not (return_stats or return_overflow):
        return slab.chans
    if return_overflow and not return_stats:
        return slab.chans, overflow
    pairs = (torch.zeros((), dtype=torch.int64, device=overflow.device)
             if cfg.render_mode_2d
             else (slab.total_pairs - slab.overflow).to(torch.int64))
    slab_pairs = _all_gather(pairs.reshape(1), tile_group, t).reshape(t)
    gathered = s * t * ecap if route == "a2a" else s * ecap
    n_wire, n_diff, exact = exchange_plan(cfg)
    n_exact = len([i for i in exact if i < n_diff])
    stats = {"overflow": overflow, "slab_pairs": slab_pairs,
             "exchange_capacity": ecap, "gathered_records": gathered,
             "exchange_wire_ops": n_wire,
             "exchange_fwd_mb_per_device": gathered * 4 * n_wire / 1e6,
             "exchange_bwd_mb_per_device":
                 gathered * (4 * n_exact + 2 * (n_diff - n_exact)) / 1e6}
    return slab.chans, stats


def sharded_render(mesh, splats: SplatData, camera: Camera,
                   cfg: RenderConfig,
                   transforms: Optional[torch.Tensor] = None,
                   scene_indices: Optional[torch.Tensor] = None,
                   scene_opacities: Optional[torch.Tensor] = None,
                   scene_visibility: Optional[torch.Tensor] = None,
                   exchange_capacity: Optional[int] = None,
                   route: str = "gather", slab_mode: str = "banded"):
    """The whole image on every rank: :func:`sharded_render_tiles`, an
    all-gather of the slabs over the tile group, de-interleaving, then
    ``assemble_image``; the dict also holds ``overflow``.  Differentiable
    with respect to the rank's splats (a loss of the image, the same on
    every rank, gives every rank its shard's gradient)."""
    chans, overflow = sharded_render_tiles(
        mesh, splats, camera, cfg, transforms=transforms,
        scene_indices=scene_indices, scene_opacities=scene_opacities,
        scene_visibility=scene_visibility,
        exchange_capacity=exchange_capacity, return_overflow=True,
        route=route, slab_mode=slab_mode)
    _, t = mesh_shape(mesh)
    _, j = mesh_coordinate(mesh)
    full = _GatherTiles.apply(chans, mesh.get_group(TILE_AXIS), t, j)
    if slab_mode == "interleaved":
        full = deinterleave_tile_order(full, t, cfg.tiles_x)
    out = assemble_image(full, cfg)
    out["overflow"] = overflow
    return out


def pad_splats_for_mesh(splats: SplatData, mesh,
                        route: str = "gather") -> SplatData:
    """Pad the splats to a multiple of the splat-shard count (of every
    rank's for 'a2a') with fully transparent splats (opacity 0, culled
    everywhere; scales 1e-6 and the identity rotation keep their
    covariances finite)."""
    n = splats.num_splats
    pad = (-n) % _shard_count(mesh, route)
    if pad == 0:
        return splats
    dev = splats.device

    def grown(x, fill=0.0):
        return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype, device=dev)])

    quats = grown(splats.quats)
    quats[n:, 3] = 1.0
    return SplatData(means=grown(splats.means),
                     scales=grown(splats.scales, 1e-6), quats=quats,
                     colors=grown(splats.colors), sh=grown(splats.sh))


def _shard_count(mesh, route: str) -> int:
    s, t = mesh_shape(mesh)
    return s * t if route == "a2a" else s


def _shard_index(mesh, route: str) -> int:
    i, j = mesh_coordinate(mesh)
    return i * mesh_shape(mesh)[1] + j if route == "a2a" else i


def local_rows(x: torch.Tensor, mesh, route: str = "gather"
               ) -> torch.Tensor:
    """This rank's rows of a per-splat array (``scene_indices``, a
    parameter), padded with zeros to a multiple of the shard count first:
    the layout of :func:`device_put_sharded_splats`."""
    count = _shard_count(mesh, route)
    pad = (-x.shape[0]) % count
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    n_l = x.shape[0] // count
    k = _shard_index(mesh, route)
    return x[k * n_l:(k + 1) * n_l]


def gather_rows(x: torch.Tensor, mesh, route: str = "gather"
                ) -> torch.Tensor:
    """The inverse of :func:`local_rows`: every rank's rows in shard order
    (all-gathered over the splat group, or over both groups for 'a2a'),
    on every rank of the mesh.  The rows come back padded, as
    :func:`device_put_sharded_splats` placed them: the first
    ``num_splats`` rows are the scene's, the rest its pad."""
    s, t = mesh_shape(mesh)
    if route == "a2a":
        x = _all_gather(x, mesh.get_group(TILE_AXIS), t).flatten(0, 1)
    return _all_gather(x, mesh.get_group(SPLAT_AXIS), s).flatten(0, 1)


def device_put_sharded_splats(splats: SplatData, mesh,
                              route: str = "gather") -> SplatData:
    """This rank's shard of the splats on its mesh device: padded
    (:func:`pad_splats_for_mesh`), then its contiguous rows, over the
    splat axis ('gather': the tile axis holds copies) or over the whole
    mesh ('a2a')."""
    padded = pad_splats_for_mesh(splats, mesh, route)
    dev = mesh_device(mesh)
    return SplatData(*(local_rows(getattr(padded, f), mesh, route).to(dev)
                       for f in ("means", "scales", "quats", "colors",
                                 "sh")))
