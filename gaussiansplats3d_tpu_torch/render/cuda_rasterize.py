"""Tile compositor, forward and backward: the hand-written CUDA kernels B1
and B2, their plain PyTorch versions, and the launch counters (counterpart
of the JAX package's ``render/pallas_rasterize.py``).

**B1 replaces** ``gaussiansplats3d_tpu/render/pallas_rasterize.py::
_composite_fwd`` (the Pallas kernel behind ``composite_tiles``).  The
kernel source is ``csrc/composite_fwd.cu``; it computes what the Pallas
kernel computes without its TPU mechanics (no DMA semaphores, no bf16-limb
MXU scan, no tiles per step): one block per tile of up to 512 threads,
each holding 2 pixels, a warp on an 8 x 8 patch of the tile
(:data:`WARP_PATCH`), for sides up to 32; a tile of side 33-64 is a
thread-block cluster of 4 such blocks, one a 32 x 32 quadrant, that vote
on the tile's exit through distributed shared memory; a tile of side 65 or
more is one block of 512 threads that walks its 32 x 32 sub-tiles, each
with its own vote from the tile's exit so far on, and runs the sub-tiles
that stopped short again to the tile's exit (``csrc/warp_cull.cuh``: the
walk), so every pixel takes the whole tile's chunks.  The tile's records
are staged 128 pairs at a time in shared memory, each warp culls the chunk
against the rectangle of its pixels (``csrc/warp_cull.cuh``;
:func:`warp_keep` is its plain mirror) and walks the kept pairs in order,
blending both pixels of a lane front to back in float32.  It keeps the
Pallas kernel's floor-aligned 128-pair chunk windows, its per-chunk
``_CS_FLOOR`` clamp on log T and its ``max T <= 1e-4`` tile exit, so
``logt`` and ``exit_k`` are the residuals B2 replays from.

**B2 replaces** ``pallas_rasterize.py::_composite_bwd`` (kernel
``_bwd_one_tile``).  Source ``csrc/composite_bwd.cu``: B1's block and
thread layout and cull; chunks ``exit_k - 1 .. 0`` in reverse.  Each warp
sweeps its kept pairs backwards with T taken from B1's residual log T
(B1's chunk sum is replayed, bit for bit, only in a warp where T may have
died in the chunk: both kernels evaluate alpha with
``csrc/gauss_fragment.cuh``, written with round-to-nearest intrinsics that
nvcc cannot contract); each pair's gradient terms are summed over the warp
by one reduce-scatter and over the block in shared memory (over a tile's
cluster of 4 blocks through distributed shared memory, each block summing
32 of the chunk's lanes; above 64 the block replays each sub-tile in turn
and adds its sums into the slots the first one wrote), and written to the
pair's slot by the tile's own block only (a slot lies in one tile's
window, so no global atomics and no read-modify-write of shared boundary
chunks).

**What bounds them on the H100.**  Each record is read once per tile that
holds it (44-48 bytes a pair), while each pair may be evaluated at every
pixel of the tile until the tile exits (1024 evaluations at tile size 32):
arithmetic, not memory, bounds both.  Both walk only the pairs whose box
reaches a warp's patch, read a pair's fields once for a lane's 2 pixels,
and test the cheap support box before the ``exp``; B2 skips the replay of
B1's sum where it can and reduces a pair's terms in one pass.  Every
tile side >= 1 runs, as in the JAX package: pixels past the tile's edge
are masked, and a warp whose patch lies wholly past it holds none and
culls every pair.

**Plain versions** (:func:`composite_fwd_torch`,
:func:`composite_bwd_torch`): the same functions in PyTorch, groups of
tiles at a time in lockstep with the same chunk windows, exit and outputs.
Each chunk evaluates only the pair-pixel entries inside the pairs' support
boxes (the rest have alpha 0) and takes the in-chunk transmittance prefix
and the backward's suffix as float64 run sums per pixel.  The wrappers use
them for CPU tensors only; for CUDA tensors they launch the kernels or
raise.

``cuda_surfel`` and ``tools/kernel_bench`` share this module's chunk
constants, input check (:func:`check_inputs`) and plain chunk loops with
their pieces (:func:`box_entries`, :func:`seg_scan`, :func:`tile_origins`).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..constants import ALPHA_CLAMP, GAUSSIAN_CUTOFF
from ..core.types import RenderConfig
from ..utils import metrics
from . import launch
from .launch import F32, I64, INT, PTR, check_cuda_launch

CHUNK = 128
# Per-chunk floor on the log-transmittance contribution (the JAX package's
# _CS_FLOOR): a chunk of near-opaque pairs can add log T ~ -590, far below
# float32 exp range; the backward replay subtracts the same clamped sums.
CS_FLOOR = math.log(1e-37)
# A tile stops once every pixel's transmittance is <= 1e-4.
EXIT_T = 1e-4
# Tiles per step of the plain versions: [64, 128, P] float32 temporaries.
GROUP_SIZE = 64
# The side of the square patch of pixels each warp of B1-B4 holds
# (csrc/warp_cull.cuh: kPatch); see warp_rects.
WARP_PATCH = 8
# The side of the quadrants of a tile of 33-64 and of the sub-tiles a
# block walks above 64 (csrc/warp_cull.cuh: kQuadSide).
SUB_TILE = 32

LAUNCHES = "b1.launches"
"""The counter (``utils.metrics``) of the launches of the CUDA kernel B1
made by :func:`composite_fwd` (the plain version does not count)."""
BWD_LAUNCHES = "b2.launches"
"""The counter of the launches of the CUDA kernel B2 made by
:func:`composite_bwd`."""


def reset_launches() -> None:
    metrics.reset(LAUNCHES, BWD_LAUNCHES)


# B1's and B3's C signature
FWD_ARGTYPES = ((PTR, I64, INT) + (PTR,) * 3 + (INT,) * 3 + (F32,) * 3
                + (PTR,) * 4)
_B1 = launch.Kernel("composite_fwd", "composite_fwd", FWD_ARGTYPES, LAUNCHES)
_B2 = launch.Kernel("composite_bwd", "composite_bwd",
                    (PTR, I64, INT) + (PTR,) * 6 + (INT,) * 3 + (F32,) * 2
                    + (PTR,) * 2, BWD_LAUNCHES)


def check_inputs(records, starts, counts, ids, cfg: RenderConfig,
                 rows: tuple = (11, 12), specs: tuple = ()):
    """Raise unless the compositor inputs are what the kernels take:
    records ``[rows[0] or rows[1], S]`` float32 (S a multiple of 128),
    ``[T]`` int32 windows and tile ids, and then the further ``(name,
    tensor, shape, dtype)`` ``specs``, all contiguous on one device."""
    if records.dtype != torch.float32 or records.dim() != 2:
        raise ValueError("records must be a 2-D float32 tensor")
    nf, s = records.shape
    if nf not in rows or s % CHUNK:
        raise ValueError(f"records must be [{rows[0]} or {rows[1]}, S] with "
                         f"S a multiple of {CHUNK}, got "
                         f"{tuple(records.shape)}")
    t = (starts.shape[0],)
    launch.check_tensors(
        records.device, ("tile_starts", starts, t, torch.int32),
        ("tile_counts", counts, t, torch.int32),
        ("tile_ids", ids, t, torch.int32))
    if not records.is_contiguous():
        raise ValueError("records must be contiguous")
    if s >= 2 ** 31:
        raise ValueError("records capacity must stay below 2^31")
    launch.check_tensors(records.device, *specs)


def composite_fwd_cuda(records, tile_starts, tile_counts, tile_ids,
                       cfg: RenderConfig):
    """Launch B1 on the current stream.  Inputs as :func:`composite_fwd`,
    all on one CUDA device; returns (chans, logt, exit_k)."""
    check_inputs(records, tile_starts, tile_counts, tile_ids, cfg)
    check_cuda_launch(records, "composite_fwd_cuda")
    nf, s = records.shape
    t = tile_starts.shape[0]
    p = cfg.tile_size * cfg.tile_size
    dev = records.device
    chans = torch.empty((t, nf - 7, p), dtype=torch.float32, device=dev)
    logt = torch.empty((t, p), dtype=torch.float32, device=dev)
    exit_k = torch.empty((t,), dtype=torch.int32, device=dev)
    _B1(dev, records.data_ptr(), s, nf - 8, tile_starts.data_ptr(),
        tile_counts.data_ptr(), tile_ids.data_ptr(), t, cfg.tile_size,
        cfg.tiles_x, cfg.min_alpha, CS_FLOOR, EXIT_T, chans.data_ptr(),
        logt.data_ptr(), exit_k.data_ptr())
    return chans, logt, exit_k


def tile_ids_from_base(tile_base, num_tiles: int, device) -> torch.Tensor:
    """The ``[num_tiles]`` int32 global tile ids a compositor call places
    its tiles at: ``tile_base + arange(num_tiles)`` for an int (the whole
    image from 0, or a banded slab), or ``tile_base`` itself, a
    ``[num_tiles]`` int32 tensor (an interleaved slab's rows)."""
    if isinstance(tile_base, torch.Tensor):
        if tile_base.shape != (num_tiles,) or tile_base.dtype != torch.int32:
            raise ValueError(f"tile ids must be [{num_tiles}] int32")
        return tile_base.to(device)
    return torch.arange(tile_base, tile_base + num_tiles, dtype=torch.int32,
                        device=device)


def tile_origins(tile_ids, cfg: RenderConfig):
    """Pixel x and y of each tile's corner, [G] float32 each."""
    ts = float(cfg.tile_size)
    tx = (tile_ids % cfg.tiles_x).to(torch.float32)
    ty = torch.div(tile_ids, cfg.tiles_x, rounding_mode="floor").to(
        torch.float32)
    return tx * ts, ty * ts


def warp_rects(cfg: RenderConfig):
    """The rectangle of pixel centres each warp of a compositor kernel
    holds (``csrc/warp_cull.cuh``'s ``rect``), as offsets from the tile's
    corner: ``[W, 4]`` float32 (x0, x1, y0, y1), one row per warp.  The
    warps tile the tile with :data:`WARP_PATCH`-square patches, row-major,
    clipped to it.  At sides 33-64 the kernels hold the tile as four 32 x
    32 quadrants, and above 64 one block walks its ceil(side / 32)^2
    sub-tiles of :data:`SUB_TILE` x :data:`SUB_TILE`, each patched from
    its corner; the quadrants and sub-tiles start at multiples of 32, so their
    patches inside the tile are these same rectangles (the order differs,
    the set does not), and a patch wholly past the tile's edge holds no
    pixel and keeps no pair."""
    ts = cfg.tile_size
    across = -(-ts // WARP_PATCH)
    w = torch.arange(across * across)
    c0, r0 = w % across * WARP_PATCH, w // across * WARP_PATCH
    c1 = torch.clamp(c0 + WARP_PATCH, max=ts) - 1
    r1 = torch.clamp(r0 + WARP_PATCH, max=ts) - 1
    return torch.stack([c0, c1, r0, r1], dim=1).to(torch.float32) + 0.5


def walk_exits(fwd_torch, records, tile_starts, tile_counts, tile_ids,
               cfg: RenderConfig):
    """The walk's bookkeeping at a side of 65 or more that is a multiple
    of :data:`SUB_TILE` (``csrc/warp_cull.cuh``: the walk), from a plain
    forward (``composite_fwd_torch`` or the surfel one): each sub-tile's
    own exit chunk, from its pixels composited alone as a tile of side 32
    at the same place over the same window, and how many sub-tiles run a
    second pass, those before the first whose own exit is the tile's.
    Returns ``(k_sub [T, g * g] int32, second [T] int64)``, sub-tiles in
    the kernels' row-major order."""
    ts = cfg.tile_size
    if ts <= 2 * SUB_TILE or ts % SUB_TILE:
        raise ValueError(f"walk_exits needs a side above {2 * SUB_TILE} that "
                         f"is a multiple of {SUB_TILE}, got {ts}")
    g = ts // SUB_TILE
    # width: every tile of the row whole, so tiles_x of side 32 is g times
    cfg32 = dataclasses.replace(cfg, tile_size=SUB_TILE,
                                width=cfg.tiles_x * ts)
    ids = tile_ids.long()
    col, row = ids % cfg.tiles_x, torch.div(ids, cfg.tiles_x,
                                            rounding_mode="floor")
    sub = torch.arange(g * g, device=ids.device)
    ids32 = ((col[:, None] * g + sub % g)
             + (row[:, None] * g + torch.div(sub, g, rounding_mode="floor"))
             * cfg32.tiles_x).reshape(-1).to(torch.int32)
    _, _, k = fwd_torch(records, tile_starts.repeat_interleave(g * g),
                        tile_counts.repeat_interleave(g * g), ids32, cfg32)
    k_sub = k.view(-1, g * g)
    return k_sub, torch.argmax(k_sub, dim=1)


def warp_keep(x, y, rx, ry, x0, x1, y0, y1):
    """The per-warp cull's predicate (``csrc/warp_cull.cuh::may_touch``),
    broadcasting, float32 as the kernel computes it: whether a pair
    centred at (x, y) with box half-widths (rx, ry) may pass the box test
    ``|p - c| <= r`` at a pixel centre of the rectangle [x0, x1] x [y0,
    y1].  A superset of that test: one pixel of slack, grown with the
    magnitudes; a NaN keeps the pair."""
    sx = 1.0 + 1e-5 * (torch.abs(x) + torch.abs(rx))
    sy = 1.0 + 1e-5 * (torch.abs(y) + torch.abs(ry))
    return ~((x - rx - sx > x1) | (x + rx + sx < x0)
             | (y - ry - sy > y1) | (y + ry + sy < y0))


def kept_pair_warps(x, y, rx, ry, tile_ids, cfg: RenderConfig):
    """How many warps of its tile keep each pair (:func:`warp_keep`
    against :func:`warp_rects`): [B] int64 for pairs with centres (x, y),
    boxes (rx, ry) and global tile ids ``tile_ids``, all [B]."""
    rects = warp_rects(cfg).to(x.device)               # [W, 4]
    tx, ty = tile_origins(tile_ids, cfg)
    keep = warp_keep(x[:, None], y[:, None], rx[:, None], ry[:, None],
                     tx[:, None] + rects[:, 0], tx[:, None] + rects[:, 1],
                     ty[:, None] + rects[:, 2], ty[:, None] + rects[:, 3])
    return keep.sum(dim=1)


def box_entries(rec, window, x0, y0, xy_row: int, box_row: int,
                cfg: RenderConfig):
    """The (tile, pixel, pair) entries of one chunk of a group of tiles
    whose pixel centre lies inside the pair's support box (centre in
    records rows ``xy_row``, ``xy_row + 1``, half-widths rx, ry in rows
    ``box_row``, ``box_row + 1``), ordered by tile, pixel, then pair: the
    others have alpha 0 and add nothing.  ``rec [NF, G, C]`` holds the
    chunk's records, ``window [G, C]`` which lanes belong to the tile.
    Returns a dict of [M] tensors: ``tile``, ``seg`` (tile * P + pixel),
    ``lane``, ``rec`` ([NF, M]) and the pixel centre ``px``, ``py``."""
    ts = cfg.tile_size
    pix = torch.arange(ts, device=rec.device).to(torch.float32)
    # GL pixel centres, as (corner + index) + 0.5
    pxs = x0[:, None] + pix + 0.5                               # [G, x]
    pys = y0[:, None] + pix + 0.5                               # [G, y]
    in_x = torch.abs(pxs[:, None, :] - rec[xy_row][..., None]) \
        <= rec[box_row][..., None]                              # [G, C, x]
    in_y = torch.abs(pys[:, None, :] - rec[xy_row + 1][..., None]) \
        <= rec[box_row + 1][..., None]                          # [G, C, y]
    in_y = in_y.permute(0, 2, 1) & window[:, None, :]           # [G, y, C]
    box = in_y[:, :, None, :] & in_x.permute(0, 2, 1)[:, None]
    tile, iy, ix, lane = box.nonzero(as_tuple=True)             # [G, y, x, C]
    return {"tile": tile, "seg": tile * (ts * ts) + iy * ts + ix,
            "lane": lane, "rec": rec[:, tile, lane], "px": pxs[tile, ix],
            "py": pys[tile, iy]}


def chunk_pairs(rec, window, x0, y0, nc, cfg: RenderConfig):
    """:func:`box_entries` of the Gaussian records, with ``dx``, ``dy``
    (pixel centre less the pair's), ``e`` = exp(-g / 2) and ``alpha``,
    clamped to 0.999 and 0 where g > 8 or alpha < min_alpha, with the
    kernels' arithmetic."""
    ent = box_entries(rec, window, x0, y0, 0, 6 + nc, cfg)
    r = ent["rec"]
    dx, dy = ent["px"] - r[0], ent["py"] - r[1]
    g = r[2] * dx * dx + 2.0 * r[3] * dx * dy + r[4] * dy * dy
    e = torch.exp(-0.5 * g)
    alpha = r[5 + nc] * e
    keep = (g <= GAUSSIAN_CUTOFF) & (alpha >= cfg.min_alpha)
    alpha = torch.where(keep, torch.clamp(alpha, max=ALPHA_CLAMP),
                        torch.zeros_like(alpha))
    return {**ent, "dx": dx, "dy": dy, "e": e, "alpha": alpha}


def seg_scan(v, seg):
    """Sums within runs of equal ``seg`` (entries grouped by seg), taken
    in float64: each entry's exclusive prefix and exclusive suffix in its
    run, and the run totals as ``(unique seg, total)``; float32 out."""
    m = v.shape[0]
    if m == 0:
        return v, v, seg, v
    idx = torch.arange(m, device=v.device)
    is_first = torch.ones(m, dtype=torch.bool, device=v.device)
    is_first[1:] = seg[1:] != seg[:-1]
    is_last = torch.ones_like(is_first)
    is_last[:-1] = is_first[1:]
    first = torch.cummax(torch.where(is_first, idx, 0), 0).values
    c = torch.cumsum(v.double(), 0)
    before = c - v.double()
    last_c = c[is_last]
    run_end = torch.repeat_interleave(last_c, torch.bincount(
        torch.cumsum(is_first.long(), 0) - 1))
    return ((before - before[first]).float(), (run_end - c).float(),
            seg[is_last], (last_c - before[is_first]).float())


def composite_fwd_torch(records, tile_starts, tile_counts, tile_ids,
                        cfg: RenderConfig):
    """The plain PyTorch version of B1, on any device: same chunk windows,
    exit rule, ``CS_FLOOR`` and outputs.  Tiles go ``GROUP_SIZE`` at a
    time, each group's chunk loop in lockstep; each chunk evaluates only
    the pair-pixel entries inside the support boxes (:func:`chunk_pairs`)
    and takes the in-chunk transmittance prefix as a run sum per pixel."""
    check_inputs(records, tile_starts, tile_counts, tile_ids, cfg)
    nc = records.shape[0] - 8
    return composite_chunks_torch(records, tile_starts, tile_counts,
                                  tile_ids, cfg, nc, 5, chunk_pairs)


def composite_chunks_torch(records, tile_starts, tile_counts, tile_ids,
                           cfg: RenderConfig, nc: int, chan_row: int,
                           entries):
    """The chunk loop of the plain compositors (B1's and the surfel
    compositor's): floor-aligned 128-pair chunk windows, the ``CS_FLOOR``
    clamp per chunk and the ``max T <= 1e-4`` exit, tiles ``GROUP_SIZE``
    at a time in lockstep.  ``entries(rec [NF, G, C], window [G, C], x0,
    y0, nc, cfg)`` gives a chunk's in-box pair-pixel entries as
    :func:`chunk_pairs` does (``seg``, ``rec`` and ``alpha`` are read);
    records rows ``chan_row .. chan_row + nc`` are the channels.  Returns
    ``(chans [T, NC + 1, P], logt [T, P], exit_k [T])``, alpha last."""
    s = records.shape[1]
    t = tile_starts.shape[0]
    p = cfg.tile_size * cfg.tile_size
    dev = records.device
    chans = torch.zeros((t, nc + 1, p), dtype=torch.float32, device=dev)
    logt = torch.zeros((t, p), dtype=torch.float32, device=dev)
    exit_k = torch.zeros((t,), dtype=torch.int32, device=dev)
    lane = torch.arange(CHUNK, device=dev)
    for g0 in range(0, t, GROUP_SIZE):
        g1 = min(g0 + GROUP_SIZE, t)
        n_g = g1 - g0
        start = tile_starts[g0:g1].long()
        count = tile_counts[g0:g1].long()
        x0, y0 = tile_origins(tile_ids[g0:g1].long(), cfg)
        start_chunk = torch.div(start, CHUNK, rounding_mode="floor")
        num_chunks = torch.div(start % CHUNK + count + CHUNK - 1, CHUNK,
                               rounding_mode="floor")
        trans = torch.ones((n_g * p,), dtype=torch.float32, device=dev)
        lt = torch.zeros_like(trans)
        col = torch.zeros((nc + 1, n_g * p), dtype=torch.float32,
                          device=dev)
        k_done = torch.zeros_like(start)
        active = num_chunks > 0
        k = 0
        while bool(active.any()):
            gpos = (start_chunk + k)[:, None] * CHUNK + lane[None, :]
            rec = records[:, torch.clamp(gpos, max=s - 1)]       # [NF, G, C]
            window = (gpos >= start[:, None]) & (
                gpos < (start + count)[:, None]) & active[:, None]
            ent = entries(rec, window, x0, y0, nc, cfg)
            seg, alpha = ent["seg"], ent["alpha"]
            logw = torch.log1p(-alpha)
            excl, _, seg_u, total = seg_scan(logw, seg)
            w = alpha * (torch.exp(excl) * trans[seg])
            chan = torch.cat([ent["rec"][chan_row:chan_row + nc],
                              torch.ones_like(alpha)[None]])
            col.index_add_(1, seg, chan * w)
            # pixels no pair reached composited nothing: csum is 0 there
            csum = torch.zeros_like(trans)
            csum[seg_u] = total
            trans = trans * torch.exp(csum)
            lt = lt + torch.clamp(csum, min=CS_FLOOR)
            k += 1
            k_done = torch.where(active, torch.full_like(k_done, k), k_done)
            active = (active & (k < num_chunks)
                      & (trans.view(n_g, p).amax(dim=1) > EXIT_T))
        chans[g0:g1] = col.view(nc + 1, n_g, p).permute(1, 0, 2)
        logt[g0:g1] = lt.view(n_g, p)
        exit_k[g0:g1] = k_done.to(torch.int32)
    return chans, logt, exit_k


def composite_fwd(records, tile_starts, tile_counts, tile_ids,
                  cfg: RenderConfig):
    """B1 on the device the tensors lie on: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.

    Args:
      records: ``[NC + 8, S]`` float32 field-major pair records (rows x, y,
        conic a/b/c, NC channels, opacity, rx, ry; binning.SortedPairs), S a
        multiple of 128.
      tile_starts / tile_counts: ``[T]`` int32 pair windows per tile; starts
        need not be 128-aligned.
      tile_ids: ``[T]`` int32 global tile ids (pixel placement).

    Returns ``(chans [T, NC + 1, P], logt [T, P], exit_k [T] int32)``: row NC
    of chans is the composited alpha (the sum of the weights), logt the
    per-chunk-clamped log transmittance, exit_k the chunks composited.
    """
    return launch.dispatch(records, composite_fwd_cuda, composite_fwd_torch)(
        records, tile_starts, tile_counts, tile_ids, cfg)


def _check_bwd_inputs(records, starts, counts, ids, logt, exit_k, gchans,
                      cfg: RenderConfig):
    t, p = starts.shape[0], cfg.tile_size * cfg.tile_size
    check_inputs(records, starts, counts, ids, cfg, specs=(
        ("logt", logt, (t, p), torch.float32),
        ("exit_k", exit_k, (t,), torch.int32),
        ("gchans", gchans, (t, records.shape[0] - 7, p), torch.float32)))


def composite_bwd_cuda(records, tile_starts, tile_counts, tile_ids, logt,
                       exit_k, gchans, cfg: RenderConfig):
    """Launch B2 on the current stream.  Inputs as :func:`composite_bwd`,
    all on one CUDA device; returns grad_records ``[NC + 8, S]``."""
    _check_bwd_inputs(records, tile_starts, tile_counts, tile_ids, logt,
                      exit_k, gchans, cfg)
    check_cuda_launch(records, "composite_bwd_cuda")
    nf, s = records.shape
    dev = records.device
    # slots outside every window and chunks past exit_k stay 0
    grad = torch.zeros((nf, s), dtype=torch.float32, device=dev)
    _B2(dev, records.data_ptr(), s, nf - 8, tile_starts.data_ptr(),
        tile_counts.data_ptr(), tile_ids.data_ptr(), logt.data_ptr(),
        exit_k.data_ptr(), gchans.data_ptr(), tile_starts.shape[0],
        cfg.tile_size, cfg.tiles_x, cfg.min_alpha, CS_FLOOR, grad.data_ptr())
    return grad


def composite_bwd_chunks_torch(records, tile_starts, tile_counts, tile_ids,
                               logt, exit_k, gch, glogt, cfg: RenderConfig,
                               nc: int, chan_row: int, alpha_max: float,
                               entries, chain):
    """The reverse loop of the plain compositor backwards (B2's and the
    surfel compositor's): :func:`composite_chunks_torch`'s chunks from
    ``exit_k - 1`` down to 0, log T replayed back from ``logt``.  ``gch
    [NC (+ 1), T * P]``: the cotangents of the channels (records rows
    ``chan_row ..``) and, in a last row, of the alpha channel; ``glogt``
    that of logt, or None.  ``chain(ent, d_alpha, gate, w, gch)`` gives a
    chunk's terms ``[NF - 2, M]`` (every row but rx, ry) from d loss / d
    alpha, 0 outside ``gate`` (0 < alpha < alpha_max).  Returns
    grad_records ``[NF, S]``."""
    nf, s = records.shape
    nd = nf - 2
    t = tile_starts.shape[0]
    p = cfg.tile_size * cfg.tile_size
    dev = records.device
    grad = torch.zeros((nf, s), dtype=torch.float32, device=dev)
    lane = torch.arange(CHUNK, device=dev)
    for g0 in range(0, t, GROUP_SIZE):
        g1 = min(g0 + GROUP_SIZE, t)
        n_g = g1 - g0
        start = tile_starts[g0:g1].long()
        count = tile_counts[g0:g1].long()
        k_exit = exit_k[g0:g1].long()
        x0, y0 = tile_origins(tile_ids[g0:g1].long(), cfg)
        start_chunk = torch.div(start, CHUNK, rounding_mode="floor")
        gch_g = gch[:, g0 * p:g1 * p]
        gl = None if glogt is None else glogt[g0:g1].reshape(-1)
        lt_after = logt[g0:g1].reshape(-1).clone()
        sg = torch.zeros_like(lt_after)     # sum of w cg behind each pair
        for k in range(int(k_exit.max()) - 1, -1, -1):
            active = k < k_exit                                # [G]
            gpos = (start_chunk + k)[:, None] * CHUNK + lane[None, :]
            rec = records[:, torch.clamp(gpos, max=s - 1)]     # [NF, G, C]
            window = (gpos >= start[:, None]) & (
                gpos < (start + count)[:, None]) & active[:, None]
            ent = entries(rec, window, x0, y0, nc, cfg)
            seg, alpha, r = ent["seg"], ent["alpha"], ent["rec"]
            logw = torch.log1p(-alpha)
            excl, _, seg_u, total = seg_scan(logw, seg)
            csum = torch.zeros_like(lt_after)
            csum[seg_u] = total
            lt_before = torch.where(
                active.repeat_interleave(p),
                lt_after - torch.clamp(csum, min=CS_FLOOR), lt_after)
            t_i = torch.exp(excl + lt_before[seg])
            w = alpha * t_i
            cg = sum(r[chan_row + c] * gch_g[c][seg] for c in range(nc))
            if gch_g.shape[0] > nc:
                cg = gch_g[nc][seg] + cg
            u = w * cg
            _, behind, _, _ = seg_scan(u, seg)
            one_minus = torch.clamp(1.0 - alpha, min=1e-6)
            d_alpha = t_i * cg - (behind + sg[seg]) / one_minus
            if gl is not None:
                d_alpha = d_alpha - gl[seg] / one_minus
            gate = (alpha > 0.0) & (alpha < alpha_max)
            d_alpha = torch.where(gate, d_alpha, torch.zeros_like(d_alpha))
            terms = chain(ent, d_alpha, gate, w, gch_g)
            acc = torch.zeros((nd, n_g * CHUNK), dtype=torch.float32,
                              device=dev)
            acc.index_add_(1, ent["tile"] * CHUNK + ent["lane"], terms)
            # windows are disjoint: each slot is written by one tile only
            grad[:nd, gpos[window]] = acc.view(nd, n_g, CHUNK)[:, window]
            sg = sg.index_add(0, seg, u)
            lt_after = lt_before
    return grad


def composite_bwd_torch(records, tile_starts, tile_counts, tile_ids, logt,
                        exit_k, gchans, cfg: RenderConfig):
    """The plain PyTorch version of B2, on any device: the reverse replay
    of chunks ``exit_k - 1 .. 0`` on B1's semantics
    (:func:`composite_bwd_chunks_torch`), over the same in-box entries as
    :func:`composite_fwd_torch`, with B2's closed-form terms."""
    _check_bwd_inputs(records, tile_starts, tile_counts, tile_ids, logt,
                      exit_k, gchans, cfg)
    nc = records.shape[0] - 8

    def chain(ent, d_alpha, gate, w, gch):
        r, seg, alpha, dx, dy = (ent["rec"], ent["seg"], ent["alpha"],
                                 ent["dx"], ent["dy"])
        d_quad = d_alpha * (-0.5 * alpha)
        ca, cb, cc = r[2], r[3], r[4]
        return torch.stack([
            d_quad * (-2.0) * (ca * dx + cb * dy),
            d_quad * (-2.0) * (cb * dx + cc * dy),
            d_quad * dx * dx,
            d_quad * 2.0 * dx * dy,
            d_quad * dy * dy,
            *(w * gch[c][seg] for c in range(nc)),
            # d alpha / d opa = e where the gate is open (and opa > 0)
            torch.where(gate & (r[5 + nc] > 0.0), d_alpha * ent["e"],
                        torch.zeros_like(d_alpha))])           # [NC+6, M]

    return composite_bwd_chunks_torch(
        records, tile_starts, tile_counts, tile_ids, logt, exit_k,
        gchans.permute(1, 0, 2).flatten(1), None, cfg, nc, 5,
        ALPHA_CLAMP, chunk_pairs, chain)


def composite_bwd(records, tile_starts, tile_counts, tile_ids, logt, exit_k,
                  gchans, cfg: RenderConfig):
    """B2 on the device the tensors lie on: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.

    Args: B1's inputs and residuals (``records``, ``tile_starts``,
    ``tile_counts``, ``tile_ids``, ``logt [T, P]``, ``exit_k [T]``) and
    ``gchans [T, NC + 1, P]``, the cotangent of B1's chans.

    Returns ``grad_records [NC + 8, S]`` in the record layout: rows x, y,
    conic a, b (the cotangent of the record's b, whose quadratic form uses
    2b), c, the NC channels and opacity; rx = ry = 0, and 0 at every slot
    outside the tiles' windows or in chunks past ``exit_k``.
    """
    return launch.dispatch(records, composite_bwd_cuda, composite_bwd_torch)(
        records, tile_starts, tile_counts, tile_ids, logt, exit_k, gchans,
        cfg)


class _CompositeTiles(torch.autograd.Function):
    """Autograd boundary of the compositor: B1 forward, B2 backward (the
    gradient reaches ``records`` only; logt and exit_k are residuals)."""

    @staticmethod
    def forward(ctx, records, tile_starts, tile_counts, tile_ids, cfg):
        chans, logt, exit_k = composite_fwd(records, tile_starts, tile_counts,
                                            tile_ids, cfg)
        ctx.mark_non_differentiable(logt, exit_k)
        ctx.save_for_backward(records, tile_starts, tile_counts, tile_ids,
                              logt, exit_k)
        ctx.cfg = cfg
        return chans, logt, exit_k

    @staticmethod
    def backward(ctx, gchans, _glogt, _gexit):
        with metrics.span("gs.composite.bwd"):
            grad = composite_bwd(*ctx.saved_tensors,
                                 gchans.to(torch.float32).contiguous(),
                                 ctx.cfg)
        return grad, None, None, None, None


def composite_tiles(cfg: RenderConfig, records, tile_starts, tile_counts,
                    tile_ids):
    """The tile compositor as the render path calls it: ``(chans, logt,
    exit_k)`` of :func:`composite_fwd`, behind a ``torch.autograd.Function``
    whose backward is :func:`composite_bwd` (kernel B2 on a CUDA device,
    its plain version on the CPU)."""
    return _CompositeTiles.apply(records, tile_starts, tile_counts, tile_ids,
                                 cfg)
