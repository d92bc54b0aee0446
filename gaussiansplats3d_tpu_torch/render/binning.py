"""Tile binning + depth sort into per-tile pair records (counterpart of the
JAX package's ``render/binning.py::bin_sort_records``).

Every visible splat's screen AABB is expanded into (tile, splat) pairs in a
static slot layout of S = lanes*N + aux_cap + pad slots (a multiple of
``CHUNK``):

  lane k  [kN, (k+1)N)  the k-th covered tile of splats whose rect fits the
                        lanes (pure elementwise over [N])
  aux     [lanes*N, +aux_cap)  every pair of the larger ("big") splats, in
                        ascending splat id, row-major over the rect; pairs
                        beyond the capacity are dropped and counted in
                        ``overflow``
  pad     up to the CHUNK multiple

One sort of the pair keys orders the slots by (tile, quantized depth) and,
unless ``cfg.forward_only``, by slot id on ties: the JAX package's unstable
two-key sort with the slot operand as tie-breaker gives exactly that order.
The records are then gathered by the sorted permutation.  (The JAX package
lets the record fields ride the sort as value operands instead — a TPU
workaround for slow gathers that the GPU does not need.)  The expansion,
sort and gather (:func:`expand_sort`) also bin the 2DGS surfel records
(``surfel.bin_sort_surfels``), whose ties always break by slot id.

The record codecs of ``mixed`` and ``packed`` precision change pixels, so
each is applied here as an elementwise quantise-then-dequantise with the
JAX package's rounding; in packed mode the tile rects come from the
quantised positions and radii, as the compositor will read them.

Gradients: every codec is straight-through (its forward bits, the
cotangent passed on unchanged in float32, as the JAX package's "packing is
forward-only").  The record gather's backward (:func:`gather_bwd`) is the
JAX package's alignment: it un-sorts the pair cotangents to their source
slots by the sort's permutation and reduces them by the slot layout
(:class:`SlotLayout`): the lanes as ``[N]`` slices summed, the aux region
as segment sums over the big-splat table, and the tail (unused aux slots
and pad, which all name splat 0) as one fixed-order sum onto splat 0.  On
a CUDA device it is the hand-written kernel ``csrc/gather_bwd.cu``, with
no atomics, so its bits repeat from call to call.  The JAX package's bf16
packing of the non-position cotangents under ``mixed``/``packed`` is a
TPU saving that the port does not copy.  The support box (rx, ry) and the
rects stay gradient-free.

The sharded path bins one tile slab at a time (:func:`slab_window`): a
band of whole tile rows (``tile_range``; tile ids relative to its first
tile) or round-robin rows (``row_window``; tile ids in local rows,
:func:`tile_bounds_strided`), with depth keys quantized against the
global depth range (``depth_bounds``).

S stays static, so nothing here waits for the device.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core.types import RenderConfig
from ..utils import metrics
from . import launch
from .launch import I64, INT, PTR
from .projection import ProjectedSplats, quantize_depth

CHUNK = 128                     # pair chunk of the compositor kernel

LAUNCHES = "gather_bwd.launches"
"""The counter (``utils.metrics``) of the CUDA kernel launches of the
record gather's backward made by :func:`gather_bwd_cuda`: two a call (the
plain version does not count)."""
# the rows of partial tail sums that gather_bwd_cuda allocates; the
# kernel's first launch runs at most one block a row
_BWD_PARTIAL_ROWS = 1024

_F16_SCALE = 16.0               # radius fixed point: 1/16 px, exact in u16
_PX_SCALE = 8.0                 # packed-mode position fixed point: 1/8 px
_PX_OFFSET = 1024.0             # covers centers up to 1024 px off-screen
_RAD_LOG = 255.0 / float(np.log2(4097.0))   # u8 log-radius code step
_COLOR_U8_SCALE = 127.5         # color channel step 1/127.5 over [0, 2]


# --- codecs: quantise-then-dequantise, elementwise on float32 -------------

class _StraightThrough(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, codec):
        return codec(v)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _straight_through(codec):
    """The codec's quantise-dequantise bits forward; the cotangent
    unchanged backward, in float32 (a cast or an integer round trip would
    round it or cut it off)."""
    @functools.wraps(codec)
    def apply(v, *args):
        return _StraightThrough.apply(v, lambda x: codec(x, *args))
    return apply


@_straight_through
def f16_round(v: torch.Tensor) -> torch.Tensor:
    """float32 -> float16 (round to nearest even) -> float32."""
    return v.to(torch.float16).to(torch.float32)


def u16r_round(v: torch.Tensor) -> torch.Tensor:
    """The u16 1/16-px radius codec (non-negative input, truncating)."""
    q = (v * _F16_SCALE).to(torch.int64) & 0xFFFF
    return q.to(torch.float32) * (1.0 / _F16_SCALE)


def px_scale_for(cfg: RenderConfig) -> float:
    """Finest u16 fixed-point step covering the viewport plus a +-1024-px
    off-screen margin: 1/16 px up to ~2K viewports, 1/8 px to ~6K."""
    span = max(cfg.width, cfg.height) + 2.0 * _PX_OFFSET
    return 16.0 if span * 16.0 <= 65536.0 else _PX_SCALE


@_straight_through
def px_round(v: torch.Tensor, scale: float) -> torch.Tensor:
    """The packed-mode u16 fixed-point position codec (idempotent)."""
    q = torch.clamp((v + _PX_OFFSET) * scale, 0.0, 65535.0).to(torch.int64)
    return q.to(torch.float32) * (1.0 / scale) - _PX_OFFSET


# Decoded radius of each u8 code, exp2(code / _RAD_LOG) - 1, as float32 bit
# patterns: the JAX package's own decode values (its exp2 as XLA evaluates
# it on the CPU, which differs from torch.exp2 and CUDA's exp2f by a few
# ulps on most codes).  The table gives every device the same radii.
_RAD_DECODE_BITS = (
    0x00000000, 0x3d07d020, 0x3d8a1090, 0x3dd28c90, 0x3e0eb7f0, 0x3e356768,
    0x3e5d5f48, 0x3e835530, 0x3e98aa04, 0x3eaeb3e4, 0x3ec578d8, 0x3edcff10,
    0x3ef54cf8, 0x3f073498, 0x3f142d46, 0x3f21940e, 0x3f2f6c98, 0x3f3dbaa8,
    0x3f4c8226, 0x3f5bc718, 0x3f6b8da4, 0x3f7bda1c, 0x3f865876, 0x3f8f0b56,
    0x3f98080a, 0x3fa1510a, 0x3faae8d8, 0x3fb4d216, 0x3fbf0f76, 0x3fc9a3be,
    0x3fd491d4, 0x3fdfdcb0, 0x3feb876a, 0x3ff7952c, 0x4002049e, 0x40087380,
    0x400f18fe, 0x4015f6e8, 0x401d0f1c, 0x40246387, 0x402bf629, 0x4033c913,
    0x403bde68, 0x40443858, 0x404cd930, 0x4055c342, 0x405ef8fe, 0x40687ce8,
    0x40725196, 0x407c79b8, 0x40837c09, 0x4088e7c0, 0x408e8176, 0x40944aba,
    0x409a451a, 0x40a07238, 0x40a6d3c5, 0x40ad6b78, 0x40b43b24, 0x40bb44a0,
    0x40c289d9, 0x40ca0cc8, 0x40d1cf76, 0x40d9d408, 0x40e21ca8, 0x40eaab98,
    0x40f38330, 0x40fca5d0, 0x41030aff, 0x4107eb24, 0x410cf4ad, 0x411228f8,
    0x4117896d, 0x411d1789, 0x4122d4cc, 0x4128c2c8, 0x412ee318, 0x41353765,
    0x413bc16f, 0x414282fb, 0x41497ddc, 0x4150b401, 0x41582758, 0x415fd9f2,
    0x4167cde2, 0x41700554, 0x41788280, 0x4180a3e2, 0x41852bb9, 0x4189da05,
    0x418eb011, 0x4193af26, 0x4198d8a6, 0x419e2df4, 0x41a3b08a, 0x41a961e7,
    0x41af4392, 0x41b55730, 0x41bb9e5d, 0x41c21ad4, 0x41c8ce60, 0x41cfbac8,
    0x41d6e1fb, 0x41de45de, 0x41e5e87d, 0x41edcbef, 0x41f5f257, 0x41fe5dec,
    0x4203887c, 0x420806ed, 0x420cab88, 0x42117788, 0x42166c44, 0x421b8b0d,
    0x4220d54c, 0x42264c77, 0x422bf202, 0x4231c77e, 0x4237ce7c, 0x423e08a6,
    0x424477ac, 0x424b1d4c, 0x4251fb5e, 0x425913b4, 0x42606844, 0x4267fb14,
    0x426fce26, 0x4277e3ab, 0x42801ee3, 0x42846f63, 0x4288e486, 0x428d7f7c,
    0x4292418e, 0x42972bfe, 0x429c4028, 0x42a17f6e, 0x42a6eb44, 0x42ac8518,
    0x42b24e78, 0x42b848f6, 0x42be7638, 0x42c4d7e4, 0x42cb6fc0, 0x42d23f8e,
    0x42d9492d, 0x42e08e90, 0x42e811a4, 0x42efd482, 0x42f7d93b, 0x43001102,
    0x43045893, 0x4308c474, 0x430d55e0, 0x43120e0f, 0x4316ee4d, 0x431bf7f4,
    0x43212c58, 0x43268cef, 0x432c1b26, 0x4331d885, 0x4337c69e, 0x433de711,
    0x43443b80, 0x434ac5aa, 0x43518756, 0x43588263, 0x435fb8aa, 0x43672c31,
    0x436edef0, 0x4376d307, 0x437f0aa8, 0x4383c401, 0x438826b6, 0x438caea5,
    0x43915d13, 0x43963334, 0x439b3263, 0x43a05bfc, 0x43a5b167, 0x43ab3423,
    0x43b0e59b, 0x43b6c766, 0x43bcdb1f, 0x43c3226d, 0x43c99f0c, 0x43d052b6,
    0x43d73f42, 0x43de669b, 0x43e5caa6, 0x43ed6d75, 0x43f5510d, 0x43fd779c,
    0x4402f1ad, 0x44074b4a, 0x440bc9dc, 0x44106e8b, 0x44153aa4, 0x441a2f76,
    0x441f4e5a, 0x442498c0, 0x442a1003, 0x442fb5ac, 0x44358b44, 0x443b9262,
    0x4441ccb6, 0x44483bdc, 0x444ee19f, 0x4455bfcf, 0x445cd84b, 0x44642d09,
    0x446bbffa, 0x44739336, 0x447ba8e5, 0x44820196, 0x44865231, 0x448ac768,
    0x448f6276, 0x4494249c, 0x44990f27, 0x449e2376, 0x44a362d8, 0x44a8cec5,
    0x44ae68b8, 0x44b43236, 0x44ba2cdf, 0x44c05a3e, 0x44c6bc0b, 0x44cd5404,
    0x44d423f6, 0x44db2dc1, 0x44e2734b, 0x44e9f686, 0x44f1b987, 0x44f9be6a,
    0x450103b3, 0x45054b57, 0x4509b750, 0x450e48d5, 0x4513011c, 0x4517e179,
    0x451ceb36, 0x45221fb6, 0x45278064, 0x452d0eb9, 0x4532cc42, 0x4538ba78,
    0x453edb07, 0x45452f98, 0x454bb9e4, 0x45527bc2, 0x455976ee, 0x4560ad5c,
    0x45682102, 0x456fd3ea, 0x4577c83b, 0x45800000,
)


@functools.lru_cache(maxsize=None)
def _rad_decode_table(device: torch.device) -> torch.Tensor:
    # made once per device: a host-to-device copy on every call would wait
    # for the device
    return torch.tensor(_RAD_DECODE_BITS, dtype=torch.int64).to(
        torch.int32).view(torch.float32).to(device)


@_straight_through
def rad_round_u8(r: torch.Tensor) -> torch.Tensor:
    """The packed-mode u8 log-radius codec: rounds UP (the box only grows,
    which is lossless) and is idempotent.  log2 is taken as
    log(x) / log(2) in float32, as the JAX package computes it."""
    log2 = torch.log(1.0 + torch.clamp(r, min=0.0)) / math.log(2.0)
    code = torch.clamp(torch.ceil((log2 - 1e-6) * _RAD_LOG), 0.0, 255.0)
    return _rad_decode_table(r.device)[code.long()]


@_straight_through
def u8_round(v: torch.Tensor, scale: float) -> torch.Tensor:
    """The packed-mode u8 color/opacity codec: round half to even at
    ``scale`` steps, clamped to [0, 255]."""
    q = torch.clamp(torch.round(v * scale), 0.0, 255.0).to(torch.int64)
    return q.to(torch.float32) * (1.0 / scale)


# --- records ----------------------------------------------------------------

@dataclass
class SortedPairs:
    """Depth/tile-sorted pair records.

    ``records`` is field-major ``[NF, S]`` float32, rows x, y, conic a/b/c,
    the NC channels (r, g, b and, with ``cfg.return_depth``, depth),
    opacity, rx, ry (NF = NC + 8) — the layout the compositor kernel reads.
    Slots outside every tile's ``[start, start + count)`` window hold no
    pair; their opacity is 0.
    """

    records: torch.Tensor       # [NF, S] float32
    tile_starts: torch.Tensor   # [num_tiles] int32
    tile_counts: torch.Tensor   # [num_tiles] int32
    total_pairs: torch.Tensor   # [] int64, pairs before the aux capacity
    overflow: torch.Tensor      # [] int64, aux pairs dropped

    @property
    def capacity(self) -> int:
        return self.records.shape[1]

    @property
    def num_channels(self) -> int:
        return self.records.shape[0] - 8


def slot_layout_for(cfg: RenderConfig, n: int):
    """Static slot layout (lanes, aux_cap, pad): S = lanes*n + aux_cap + pad
    is a CHUNK multiple.  aux_multiplier <= 0 disables the aux path."""
    lanes = cfg.lanes
    if cfg.aux_multiplier <= 0:
        aux = 0
    else:
        # Floor of 4096: small zoomed-in scenes can be dominated by big
        # splats, whose aux pairs far exceed aux_multiplier * n.
        aux = max(4096, int(n * cfg.aux_multiplier))
    pad = (-(lanes * n + aux)) % CHUNK
    return lanes, aux, pad


def _tile_of(v, cfg: RenderConfig):
    # clamp before the integer cast: the JAX package's cast saturates
    return torch.clamp(torch.floor(v / float(cfg.tile_size)), -2.0 ** 30,
                       2.0 ** 30).to(torch.int64)


def tile_bounds(xs, ys, rx, ry, mask, cfg: RenderConfig, ty_lo: int = 0,
                ty_hi: int | None = None):
    """Inclusive tile bounds [tx0, tx1] x [ty0, ty1] per splat (int64) and
    the pair count (0 for culled splats or rects off the viewport, or off
    the tile-row window ``[ty_lo, ty_hi)`` when given: a banded slab of
    the sharded path)."""
    if ty_hi is None:
        ty_hi = cfg.tiles_y
    tx0, tx1 = _tile_of(xs - rx, cfg), _tile_of(xs + rx, cfg)
    ty0, ty1 = _tile_of(ys - ry, cfg), _tile_of(ys + ry, cfg)
    inside = (mask & (tx1 >= 0) & (ty1 >= ty_lo)
              & (tx0 < cfg.tiles_x) & (ty0 < ty_hi))
    tx0 = torch.clamp(tx0, 0, cfg.tiles_x - 1)
    tx1 = torch.clamp(tx1, 0, cfg.tiles_x - 1)
    ty0 = torch.clamp(ty0, ty_lo, ty_hi - 1)
    ty1 = torch.clamp(ty1, ty_lo, ty_hi - 1)
    counts = torch.where(inside, (tx1 - tx0 + 1) * (ty1 - ty0 + 1),
                         torch.zeros_like(tx0))
    return tx0, tx1, ty0, ty1, counts


def strided_row_range(ty0, ty1, row_start: int, row_stride: int):
    """Local row range [lo, hi] of a global tile-row rect [ty0, ty1] under
    round-robin ownership (the owner holds rows {row_start + r *
    row_stride}); empty iff hi < lo.  The one source of this ceil/floor
    arithmetic: the strided rects (:func:`tile_bounds_strided`) and the
    sharded exchange's touch filter both call it, so the filter stays a
    superset of the binning window.  Integer ``//`` floors, so it is exact
    for rows below ``row_start`` too."""
    lo = -((row_start - ty0) // row_stride)          # ceil((ty0 - j) / s)
    hi = (ty1 - row_start) // row_stride             # floor((ty1 - j) / s)
    return lo, hi


def tile_bounds_strided(xs, ys, rx, ry, mask, cfg: RenderConfig,
                        row_start: int, row_stride: int, rows_per: int):
    """Tile bounds in the local rows of a strided (round-robin) slab that
    owns global rows {row_start + r * row_stride}, r < rows_per: a global
    rect [ty0, ty1] maps to the local rows of :func:`strided_row_range`,
    so the expansion, keys and sort run unchanged on the local grid.
    Returns (tx0, tx1, ty0_l, ty1_l, counts) as :func:`tile_bounds`, with
    counts 0 where no owned row is hit."""
    tx0, tx1 = _tile_of(xs - rx, cfg), _tile_of(xs + rx, cfg)
    ty0u, ty1u = _tile_of(ys - ry, cfg), _tile_of(ys + ry, cfg)
    # the viewport test reads the unclipped rows: clipping first would fold
    # a rect wholly off the screen onto its first or last row
    ty0_l, ty1_l = strided_row_range(
        torch.clamp(ty0u, 0, cfg.tiles_y - 1),
        torch.clamp(ty1u, 0, cfg.tiles_y - 1), row_start, row_stride)
    inside = (mask & (tx1 >= 0) & (tx0 < cfg.tiles_x)
              & (ty1u >= 0) & (ty0u < cfg.tiles_y)
              & (ty1_l >= ty0_l) & (ty1_l >= 0) & (ty0_l < rows_per))
    tx0 = torch.clamp(tx0, 0, cfg.tiles_x - 1)
    tx1 = torch.clamp(tx1, 0, cfg.tiles_x - 1)
    ty0_l = torch.clamp(ty0_l, 0, rows_per - 1)
    ty1_l = torch.clamp(ty1_l, 0, rows_per - 1)
    counts = torch.where(inside, (tx1 - tx0 + 1) * (ty1_l - ty0_l + 1),
                         torch.zeros_like(tx0))
    return tx0, tx1, ty0_l, ty1_l, counts


def slab_window(cfg: RenderConfig, tile_range: tuple | None,
                row_window: tuple | None):
    """``(bounds, num_tiles, tile_lo)`` of a binning window: ``bounds(xs,
    ys, rx, ry, mask)`` is :func:`tile_bounds` over the whole image or the
    banded ``tile_range = (tile_lo, num_local_tiles)`` (whole tile rows;
    tile ids come out relative to tile_lo), or :func:`tile_bounds_strided`
    over ``row_window = (row_start, row_stride, rows_per)`` (tile ids in
    local rows)."""
    if row_window is not None:
        if tile_range is not None:
            raise ValueError("row_window replaces tile_range")
        row_start, row_stride, rows_per = row_window

        def strided(xs, ys, rx, ry, mask):
            return tile_bounds_strided(xs, ys, rx, ry, mask, cfg, row_start,
                                       row_stride, rows_per)
        return strided, rows_per * cfg.tiles_x, 0
    if tile_range is None:
        tile_lo, num_tiles = 0, cfg.num_tiles
    else:
        tile_lo, num_tiles = tile_range
        if num_tiles % cfg.tiles_x or tile_lo % cfg.tiles_x:
            raise ValueError(f"tile_range {tile_range} must cover whole "
                             f"tile rows of {cfg.tiles_x} tiles")
    ty_lo = tile_lo // cfg.tiles_x
    ty_hi = ty_lo + num_tiles // cfg.tiles_x

    def banded(xs, ys, rx, ry, mask):
        return tile_bounds(xs, ys, rx, ry, mask, cfg, ty_lo, ty_hi)
    return banded, num_tiles, tile_lo


def _lane_tiles(cfg: RenderConfig, counts, tx0, ty0, wt, ht, tile_lo: int):
    """Per-lane (tile id, valid) and the lane-coverable 'small' predicate;
    tile ids relative to ``tile_lo``."""
    tiles_x = cfg.tiles_x
    tile0 = ty0 * tiles_x + tx0 - tile_lo
    if cfg.lanes == 1:
        small = counts == 1
        return small, [(tile0, small)]
    if cfg.lanes == 2:
        small = (counts >= 1) & (counts <= 2)
        # second tile: right neighbour for 2x1 rects, below for 1x2
        step = torch.where(wt > 1, torch.ones_like(wt),
                           torch.full_like(wt, tiles_x))
        return small, [(tile0, small),
                       (tile0 + step, small & (counts == 2))]
    small = (counts >= 1) & (wt <= 2) & (ht <= 2)
    return small, [
        (tile0, small),
        (tile0 + 1, small & (wt > 1)),
        (tile0 + tiles_x, small & (ht > 1)),
        (tile0 + tiles_x + 1, small & (wt > 1) & (ht > 1)),
    ]


def _record_fields(proj: ProjectedSplats, cfg: RenderConfig, rx, ry):
    """The [N] record rows after the precision's codecs (layout of
    SortedPairs.records)."""
    chans = [proj.col_r, proj.col_g, proj.col_b]
    if cfg.return_depth:
        # culled splats carry +inf depth: zero it so 0-weight slots stay finite
        chans.append(torch.where(proj.mask, proj.depth,
                                 torch.zeros_like(proj.depth)))
    geo = [proj.xs, proj.ys, proj.conic_a, proj.conic_b, proj.conic_c]
    opa = proj.opacity
    prec = cfg.record_precision
    if prec == "f32":
        return geo + chans + [opa, u16r_round(rx), u16r_round(ry)]
    if prec == "mixed":
        rgb = [f16_round(c) for c in chans[:3]]
        return geo + rgb + chans[3:] + [f16_round(opa), u16r_round(rx),
                                        u16r_round(ry)]
    scale = px_scale_for(cfg)
    geo = ([px_round(v, scale) for v in geo[:2]]
           + [f16_round(v) for v in geo[2:]])
    rgb = [u8_round(c, _COLOR_U8_SCALE) for c in chans[:3]]
    depth = [f16_round(c) for c in chans[3:]]
    return geo + rgb + depth + [u8_round(opa, 255.0), rad_round_u8(rx),
                                rad_round_u8(ry)]


@dataclass
class SlotLayout:
    """The slot layout of one :func:`expand_sort` call, what the record
    gather's backward reduces by: ``S = lanes * n + aux_cap + pad`` slots.
    Slot ``k * n + i`` of lane k names splat i.  Aux slot ``lanes * n +
    t`` names the splat of the big-splat table's row r whose segment
    ``[offs_c[r], offs_c[r] + counts_c[r])`` holds t; ``dest[i]`` is splat
    i's row, or ``b_cap`` (the table's length) if it has none.  The aux
    slots from ``covered`` (the table's last end) on and the pad slots name
    splat 0: the table then has rows to spare, and its last row is empty
    and names 0.  Without an aux region the table's tensors are None."""

    n: int
    lanes: int
    aux_cap: int
    pad: int
    dest: torch.Tensor | None = None        # [n] int64
    offs_c: torch.Tensor | None = None      # [b_cap] int64
    counts_c: torch.Tensor | None = None    # [b_cap] int64
    covered: torch.Tensor | None = None     # [] int64

    @property
    def slots(self) -> int:
        return self.lanes * self.n + self.aux_cap + self.pad


def gather_bwd_torch(g, perm, layout: SlotLayout):
    """The plain PyTorch version of :func:`gather_bwd`, on any device and
    float dtype: un-sort the cotangents (``g[:, inv]``, ``inv[perm[j]] =
    j``), sum the lanes in order, the aux segments by
    ``torch.segment_reduce``, and add the tail onto splat 0 last."""
    f, s = g.shape
    n, lanes, aux_cap = layout.n, layout.lanes, layout.aux_cap
    body = lanes * n
    inv = torch.empty(s, dtype=torch.int64, device=g.device)
    inv[perm] = torch.arange(s, device=g.device)
    aligned = g[:, inv]
    d = aligned[:, :n].clone()
    for k in range(1, lanes):
        d += aligned[:, k * n:(k + 1) * n]
    kept = 0
    if layout.dest is not None:
        kept = min(int(layout.covered), aux_cap)
        offsets = torch.cat([torch.clamp(layout.offs_c, max=aux_cap),
                             torch.tensor([kept], device=g.device)])
        seg = torch.segment_reduce(aligned[:, body:body + kept].T, "sum",
                                   offsets=offsets, axis=0)     # [b_cap, f]
        ids = torch.nonzero(layout.dest < layout.offs_c.shape[0])[:, 0]
        d[:, ids] = d[:, ids] + seg[layout.dest[ids]].T
    if s > body + kept:
        d[:, 0] += aligned[:, body + kept:].sum(dim=1)
    return d, aux_cap - kept + layout.pad


def _check_gather_bwd(g, perm, layout: SlotLayout):
    """Raise unless csrc/gather_bwd.cu takes these inputs: g ``[F, S]``
    float32 (F <= 32), perm ``[S]`` int64, the table's tensors int64 of
    their lengths (given iff aux_cap > 0), all contiguous on one CUDA
    device.  Lean: it runs once a training step, on the host's path."""
    if g.dtype != torch.float32 or g.dim() != 2 or not g.is_contiguous():
        raise ValueError("the cotangent must be a contiguous 2-D float32 "
                         "tensor")
    f, s = g.shape
    if not 1 <= f <= 32 or s != layout.slots:
        raise ValueError(f"cotangent {tuple(g.shape)} does not fit the "
                         f"layout of {layout.slots} slots (at most 32 "
                         f"rows)")
    want = [("perm", perm, (s,), torch.int64)]
    if layout.aux_cap:
        b_cap = (layout.offs_c.shape[0],)
        want += [("dest", layout.dest, (layout.n,), torch.int64),
                 ("offs_c", layout.offs_c, b_cap, torch.int64),
                 ("counts_c", layout.counts_c, b_cap, torch.int64),
                 ("covered", layout.covered, (), torch.int64)]
    elif layout.dest is not None:
        raise ValueError("a big-splat table without an aux region")
    launch.check_tensors(g.device, *want)
    launch.check_cuda_launch(g, "gather_bwd_cuda")


def row_width(f: int) -> int:
    """The floats of a slot row of csrc/gather_bwd.cu's aligned
    cotangents for f record rows: whole 32-byte sectors (16 for the 3D
    records' 11 or 12 rows, 24 for the surfels' 17 or 18), so that no
    scattered row shares a sector with another.  On an H100 the garden
    cell's backward took 2.39 ms with 48-byte rows, 1.67 with 64."""
    return 8 * (-(-f // 8))


_GATHER_BWD = launch.Kernel(
    "gather_bwd", "gather_bwd",
    (PTR, INT, INT, I64, PTR, I64, INT) + (I64,) * 2 + (PTR,) * 3 + (I64,)
    + (PTR,) * 3 + (INT,) + (PTR,) * 3, LAUNCHES, launches=2)


def launch_gather_bwd(g, perm, layout: SlotLayout, aligned, partials, d,
                      tail):
    """csrc/gather_bwd.cu's two kernels on the current stream, into the
    buffers given: ``aligned [lanes * n + aux_cap, row_width(F)]`` and
    ``partials [rows, row_width(F)]`` float32 scratch (the first kernel
    runs at most ``rows`` blocks), ``d [F, n]`` float32 and ``tail []``
    int64, all contiguous on g's device.  g, perm and layout as
    :func:`gather_bwd`, checked by the caller."""
    f, s = g.shape

    def ptr(t):
        return t.data_ptr() if t is not None else None

    _GATHER_BWD(
        g.device, g.data_ptr(), f, aligned.shape[1], s, perm.data_ptr(),
        layout.n, layout.lanes, layout.aux_cap, layout.pad, ptr(layout.dest),
        ptr(layout.offs_c), ptr(layout.counts_c),
        layout.offs_c.shape[0] if layout.dest is not None else 0,
        ptr(layout.covered), aligned.data_ptr(), partials.data_ptr(),
        partials.shape[0], d.data_ptr(), tail.data_ptr())


def gather_bwd_cuda(g, perm, layout: SlotLayout):
    """Launch csrc/gather_bwd.cu's two kernels on the current stream.
    Inputs as :func:`gather_bwd`, on one CUDA device; returns ``(d [F, n]
    float32, tail slots [] int64)``."""
    _check_gather_bwd(g, perm, layout)
    f, s = g.shape
    dev = g.device
    d = torch.empty((f, layout.n), dtype=torch.float32, device=dev)
    if s == 0:          # no splats and no aux region: nothing to launch
        return d, torch.tensor(0, device=dev)
    # one scratch allocation: the aligned rows, then the tail's partials
    rows = layout.lanes * layout.n + layout.aux_cap
    scratch = torch.empty((rows + _BWD_PARTIAL_ROWS, row_width(f)),
                          dtype=torch.float32, device=dev)
    tail = torch.empty((), dtype=torch.int64, device=dev)
    launch_gather_bwd(g, perm, layout, scratch[:rows], scratch[rows:], d,
                      tail)
    return d, tail


def gather_bwd(g, perm, layout: SlotLayout):
    """The gradient of ``fields.index_select(1, src)`` for the cotangent
    ``g [F, S]`` of the sorted records, where ``src`` is the source splat
    of slot ``perm[j]`` (the sort's permutation) under ``layout``: ``(d
    [F, n], the slots folded into splat 0 by the tail)``.  Every slot's
    cotangent reaches its splat, those outside every tile's window too, so
    it is the exact gradient for any cotangent.  CUDA tensors launch
    :func:`gather_bwd_cuda`; CPU tensors take :func:`gather_bwd_torch`."""
    return launch.dispatch(g, gather_bwd_cuda, gather_bwd_torch)(g, perm,
                                                                 layout)


class _Gather(torch.autograd.Function):
    """The record gather ``fields.index_select(1, src)``, ``src`` the
    source splat of each sorted slot; its backward (:func:`gather_bwd`)
    un-sorts the pair cotangents by ``perm`` and reduces them by the slot
    ``layout``, inside the span ``gs.bin.gather_bwd``, and observes the
    tail's slots as ``bin.bwd_tail``."""

    @staticmethod
    def forward(ctx, fields, src, perm, layout):
        ctx.save_for_backward(perm)
        ctx.layout = layout
        return fields.index_select(1, src)

    @staticmethod
    def backward(ctx, grad):
        with metrics.span("gs.bin.gather_bwd"):
            perm, = ctx.saved_tensors
            d, tail = gather_bwd(grad.contiguous(), perm, ctx.layout)
            metrics.observe("bin.bwd_tail", tail)
            return d, None, None, None


def expand_sort(cfg: RenderConfig, tx0, ty0, wt, ht, counts, depth_q,
                fields, opa_row: int, carry_slot: bool,
                num_tiles: int | None = None, tile_lo: int = 0,
                aux_capacity: int | None = None):
    """Expand splats into (tile, splat) pair slots, sort the slots by
    (tile, quantized depth) and, with ``carry_slot``, slot id on ties, and
    gather the ``[N]`` record ``fields`` into that order.

    ``tx0``/``ty0``/``wt``/``ht``/``counts`` are the rects of one of
    :func:`slab_window`'s bounds; tile ids are ``ty0 * tiles_x + tx0 -
    tile_lo`` over ``num_tiles`` tiles (default: the whole image), and
    ``aux_capacity`` overrides the aux slots of :func:`slot_layout_for`.
    Returns ``(records [F, S], tile_starts, tile_counts, total_pairs,
    overflow)``; row ``opa_row`` of records is 0 at every slot outside the
    tiles' windows.  The gather is differentiable: its backward
    (:func:`gather_bwd`) sends each pair's cotangent to its source splat by
    the slot layout.
    """
    dev = depth_q.device
    n = depth_q.shape[0]
    if num_tiles is None:
        num_tiles = cfg.num_tiles
    lanes, aux_cap, pad = slot_layout_for(cfg, n)
    if aux_capacity is not None:
        aux_cap = aux_capacity
        pad = (-(lanes * n + aux_cap)) % CHUNK
    s_total = lanes * n + aux_cap + pad

    small, lane_defs = _lane_tiles(cfg, counts, tx0, ty0, wt, ht,
                                   tile_lo)
    big = (counts >= 1) & ~small
    counts_aux = torch.where(big, counts, torch.zeros_like(counts))
    total_aux = counts_aux.sum()
    kept_aux = 0
    iota_n = torch.arange(n, device=dev)
    table = ()

    tiles = [t for t, _ in lane_defs]
    valids = [v for _, v in lane_defs]
    depths = [depth_q] * lanes
    srcs = [iota_n] * lanes
    if aux_cap > 0:
        # Compact table of big splats in ascending id; ceil(aux_cap /
        # min_big) rows provably cover aux_cap pairs (a big splat has at
        # least lanes+1 pairs, >= 3 for 2 and 4 lanes).
        min_big = 2 if lanes == 1 else 3
        b_cap = -(-max(128, -(-aux_cap // min_big)) // 128) * 128
        rank_b = torch.cumsum(big.to(torch.int64), 0) - 1
        dest = torch.where(big & (rank_b < b_cap), rank_b,
                           torch.full_like(rank_b, b_cap))
        big_c = torch.zeros(b_cap + 1, dtype=torch.int64, device=dev)
        big_c = big_c.scatter(0, dest, iota_n)[:b_cap]
        n_big = big.sum()
        vb = torch.arange(b_cap, device=dev) < n_big
        counts_c = torch.where(vb, counts_aux[big_c],
                               torch.zeros_like(big_c))
        ends_c = torch.cumsum(counts_c, 0)
        offs_c = ends_c - counts_c
        covered = ends_c[-1]
        iota_a = torch.arange(aux_cap, device=dev)
        owner = torch.clamp(
            torch.searchsorted(ends_c, iota_a, right=True), max=b_cap - 1)
        sid = big_c[owner]
        rank = iota_a - offs_c[owner]
        bw = torch.clamp(wt[sid], min=1)
        tiles.append((ty0[sid] + rank // bw) * cfg.tiles_x
                     + tx0[sid] + rank % bw - tile_lo)
        kept_aux = torch.clamp(covered, max=aux_cap)
        valids.append(iota_a < kept_aux)
        depths.append(depth_q[sid])
        srcs.append(sid)
        overflow = total_aux - kept_aux
        table = (dest, offs_c, counts_c, covered)
    else:
        overflow = total_aux
    if pad:
        zeros = torch.zeros(pad, dtype=torch.int64, device=dev)
        tiles.append(zeros)
        valids.append(torch.zeros(pad, dtype=torch.bool, device=dev))
        depths.append(zeros)
        srcs.append(zeros)

    valid = torch.cat(valids)
    tile = torch.where(valid, torch.cat(tiles),
                       torch.full((s_total,), num_tiles, device=dev))
    depth = torch.cat(depths)
    shift = cfg.sort_bits
    if carry_slot:
        # Slot id as the tie-breaker, as in the JAX package's sort.
        shift += max(1, (s_total - 1).bit_length())
    if num_tiles.bit_length() + shift > 63:
        raise ValueError("pair sort key exceeds 63 bits")
    key = (tile << shift) | (depth << (shift - cfg.sort_bits))
    if carry_slot:
        key = key | torch.arange(s_total, device=dev)
    sorted_key, perm = torch.sort(key)
    sorted_tile = sorted_key >> shift
    src = torch.cat(srcs)[perm]

    layout = SlotLayout(n, lanes, aux_cap, pad, *table)
    records = _Gather.apply(torch.stack(fields), src, perm, layout)
    records[opa_row] = torch.where(sorted_tile < num_tiles, records[opa_row],
                                   torch.zeros_like(records[opa_row]))

    tile_ids = torch.arange(num_tiles, device=dev)
    starts = torch.searchsorted(sorted_tile, tile_ids)
    ends = torch.searchsorted(sorted_tile, tile_ids, right=True)
    lane_pairs = sum(v.sum() for v in valids[:lanes])
    total = lane_pairs + total_aux
    metrics.observe("bin.calls", 1)
    metrics.observe("bin.slots", s_total)
    # kept = the lanes' pairs + the aux slots filled (total - overflow
    # without a kernel launched to count)
    metrics.observe("bin.pairs_kept", lane_pairs)
    metrics.observe("bin.pairs_kept", kept_aux)
    metrics.observe("bin.dropped", overflow)
    return (records, starts.to(torch.int32), (ends - starts).to(torch.int32),
            total, overflow)


@metrics.traced("gs.bin")
def bin_sort_records(proj: ProjectedSplats, cfg: RenderConfig,
                     tile_range: tuple | None = None,
                     depth_bounds: tuple | None = None,
                     aux_capacity: int | None = None,
                     row_window: tuple | None = None) -> SortedPairs:
    """Expand splats into depth-sorted per-tile pair records.

    The sharded path's slab arguments (:func:`slab_window`): ``tile_range =
    (tile_lo, num_local_tiles)``, a band of whole tile rows, with tile ids
    relative to tile_lo; or ``row_window = (row_start, row_stride,
    rows_per)``, round-robin rows, with tile ids in local rows.
    ``depth_bounds = (dmin, dmax)`` quantizes depth against the global range
    (``projection.quantize_depth``); ``aux_capacity`` overrides the aux
    slots of :func:`slot_layout_for`.
    """
    bounds, num_tiles, tile_lo = slab_window(cfg, tile_range, row_window)
    depth_q = quantize_depth(proj.depth, proj.mask, cfg.sort_bits,
                             depth_bounds)
    # The support box is a hard, gradient-free cutoff.
    rx, ry = proj.rx.detach(), proj.ry.detach()
    xs, ys = proj.xs.detach(), proj.ys.detach()
    if cfg.record_precision == "packed":
        # Rects from the values the compositor will read (box contract).
        rx, ry = rad_round_u8(rx), rad_round_u8(ry)
        scale = px_scale_for(cfg)
        xs, ys = px_round(xs, scale), px_round(ys, scale)
    tx0, tx1, ty0, ty1, counts = bounds(xs, ys, rx, ry, proj.mask)
    fields = _record_fields(proj, cfg, rx, ry)
    records, starts, tcounts, total, overflow = expand_sort(
        cfg, tx0, ty0, tx1 - tx0 + 1, ty1 - ty0 + 1, counts, depth_q, fields,
        opa_row=len(fields) - 3, carry_slot=not cfg.forward_only,
        num_tiles=num_tiles, tile_lo=tile_lo, aux_capacity=aux_capacity)
    return SortedPairs(records=records, tile_starts=starts,
                       tile_counts=tcounts, total_pairs=total,
                       overflow=overflow)
