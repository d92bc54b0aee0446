"""What the compositor kernels' function needs, as float32 operations and
bytes, and the least time the H100 could take for it.

Copied from ``chip_smoke.py`` (``visited_slots``, ``visit_counts``,
``tier_ops``, ``b1_work``, ``b2_work``, ``surfel_visit_counts``,
``surfel_tier_ops``, ``b3_work``, ``b4_work``, ``bound_of`` and their
constants) so that a change to the program cannot move the yardstick,
without ``cull_counts``: the pair-warps a per-warp cull keeps are work of
one layout, not of the function.  The surfel fragment's arithmetic is
written out here rather than called from the program.

Every count is of what these inputs need: the pairs in each tile's chunks
before its exit (``exit_k``), each at every pixel of its tile.
"""

from __future__ import annotations

import torch

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores and
# HBM3 bandwidth, at the full 700 W power limit.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
CHUNK = 128                     # the compositors' pair chunk
GAUSSIAN_CUTOFF = 8.0
SURFEL_NEAR = 0.2
SURFEL_ALPHA_MAX = 0.99
# float32 operations B1's function needs (an FMA counts two).  Per pair
# visited in a tile, not per pixel: clip the pair's rx/ry box to the tile
# (cx -+ rx, cy -+ ry and their max/min with the tile's edges); the pixels
# outside the clipped box need nothing more.
OPS_PAIR_TILE = 8
# Per pair-pixel visit, by how far it gets through the cut-offs: inside the
# box, dx, dy and g = a dx^2 + 2b dx dy + c dy^2 (7 mul, 2 add), g <= 8;
OPS_IN_BOX = 12
# inside the g cut-off: -0.5 g, exp, * opacity, alpha >= min_alpha;
OPS_IN_CUTOFF = 4
# contributing: the 0.999 clamp, w = alpha T, T -= w, then one FMA for each
# of the NC channels and the alpha row (2 each).
OPS_BLEND_BASE = 3
# B2 replays the same visits as B1 (chunks < exit_k).  Its first pass
# recomputes each chunk's log-transmittance sum: B1's tiers up to the
# cut-offs, then, per contributing visit, the clamp, log1p and the add.
OPS_B2_REPLAY = 3
# The sweep repeats the tiers; per contributing visit it then does (an FMA
# counts two): clamp, log1p, the running sum (3); T = exp(chunk_log - rest
# + logt) and w = alpha T (4); d_alpha = T cg - S / max(1 - alpha, 1e-6)
# and its two gate tests (7); S += w cg (2); d_quad (2); d_mean (10);
# d_conic (7); d_opa and its test (2); the alpha row of cg (1) = 38; then
# per channel the FMA of cg and d_chan = w g (3), and the NC + 6 adds that
# sum the terms over the tile's pixels.
OPS_B2_GRAD_BASE = 38 + 6
OPS_B2_GRAD_PER_CHANNEL = 3 + 1
# per pixel and replayed chunk: logt_before = logt_after - max(sum, floor)
OPS_B2_CHUNK = 2
# pairs a step of the work count evaluates at every pixel of their tile
WORK_PAIRS_PER_STEP = 1 << 15
# B3's tiers (an FMA counts two): per pair-pixel visit inside the box, dx,
# dy (2), k and l (12), p = k x l (9), |p.z| test (1), s = p.xy / p.z (2),
# rho3d (3), rho2d (4), the comparison (1), depth (4), its test (1);
SURF_OPS_IN_BOX = 39
# past the |p.z| and depth cuts: -0.5 rho, exp, * opacity, the 0.99 clamp,
# the min_alpha test;
SURF_OPS_PAST_CUTS = 5
# contributing: w = alpha exp(chunk_log) T (3), chunk_log += log1p (2), then
# one FMA for each of the NC channels (2 each).
SURF_OPS_BLEND_BASE = 5
# B4 walks B3's tiers twice (the chunk sum's recompute and the sweep).  Per
# contributing visit: the recompute's log1p and add (2); the sweep's log1p
# and running sum (2), T = exp(chunk_log - rest + logt) (3), w (1), d_alpha
# with its gate, 1 - alpha and two divisions (8), S += w cg (2), d_rho (3),
# d_su/d_sv or d_dx/d_dy (4), 1 / p.z (1), d_p (6), d_k and d_l (18), the 9
# T terms (18), the center (2), the opacity (2) = 72, and the 12 adds that
# sum the T, center and opacity terms over the tile's pixels; per channel
# the FMA of cg (2), w gcol (2) and its add (1).
OPS_B4_GRAD_BASE = 72 + 12
OPS_B4_GRAD_PER_CHANNEL = 5


def bound_of(ops, nbytes):
    """(bound ms, 'operations' or 'bytes', ops ms, bytes ms) on the
    published H100 peaks."""
    ops_ms = ops / PEAK_F32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", ops_ms, bytes_ms)


def visited_slots(starts, counts, exit_k, tiles_total):
    """The (tile, slot) of every window pair in chunks < exit_k (each is
    visited at every pixel of its tile), and how many there are."""
    dev = starts.device
    start = starts.long()
    end = torch.minimum(start + counts.long(),
                        (start // CHUNK + exit_k.long()) * CHUNK)
    n_done = torch.clamp(end - start, min=0)
    total = int(n_done.sum())
    tiles = torch.arange(tiles_total, device=dev)
    tile = torch.repeat_interleave(tiles, n_done, output_size=total)
    first = torch.cumsum(n_done, 0) - n_done
    slot = start[tile] + torch.arange(total, device=dev) - first[tile]
    return tile, slot, total


def _tile_origin(t_i, ts, tiles_x):
    x0 = ((t_i % tiles_x) * ts).float()
    y0 = torch.div(t_i, tiles_x, rounding_mode="floor").float() * ts
    return x0, y0


def visit_counts(records, starts, counts, exit_k, geom, min_alpha):
    """The pairs each tile visits before its exit, their pair-pixel visits
    (at every pixel of the tile), how many pass the rx/ry box, the g <= 8
    cut-off and min_alpha; and the pairs visited.  ``geom``: (tile side,
    tiles across, tiles in all)."""
    ts, tiles_x, tiles_total = geom
    dev = records.device
    tile, slot, total = visited_slots(starts, counts, exit_k, tiles_total)
    pix = torch.arange(ts, device=dev, dtype=torch.float32) + 0.5
    nc = records.shape[0] - 8
    out = {"pairs": total, "visits": total * ts * ts, "in_box": 0,
           "in_cutoff": 0, "contributing": 0}
    for i in range(0, total, WORK_PAIRS_PER_STEP):
        rec = records[:, slot[i:i + WORK_PAIRS_PER_STEP]]
        x0, y0 = _tile_origin(tile[i:i + WORK_PAIRS_PER_STEP], ts, tiles_x)
        dx = (x0[:, None] + pix[None, :]) - rec[0][:, None]        # [B, ts]
        dy = (y0[:, None] + pix[None, :]) - rec[1][:, None]
        in_box = ((dy.abs() <= rec[7 + nc][:, None])[:, :, None]
                  & (dx.abs() <= rec[6 + nc][:, None])[:, None, :])
        dx, dy = dx[:, None, :], dy[:, :, None]                 # [B, y, x]
        g = (rec[2][:, None, None] * dx * dx
             + 2.0 * rec[3][:, None, None] * dx * dy
             + rec[4][:, None, None] * dy * dy)
        in_cut = in_box & (g <= GAUSSIAN_CUTOFF)
        alpha = rec[5 + nc][:, None, None] * torch.exp(-0.5 * g)
        out["in_box"] += int(in_box.sum())
        out["in_cutoff"] += int(in_cut.sum())
        out["contributing"] += int((in_cut & (alpha >= min_alpha)).sum())
    return out, total


def tier_ops(counts):
    return (counts["pairs"] * OPS_PAIR_TILE + counts["in_box"] * OPS_IN_BOX
            + counts["in_cutoff"] * OPS_IN_CUTOFF)


def b1_work(records, starts, counts, exit_k, geom, min_alpha):
    """(ops, bytes) of B1's function on these records."""
    c, total = visit_counts(records, starts, counts, exit_k, geom,
                            min_alpha)
    nc = records.shape[0] - 8
    ops = tier_ops(c) + c["contributing"] * (OPS_BLEND_BASE + 2 * (nc + 1))
    ts, _, t = geom
    p = ts * ts
    # records of the pairs composited, read once; starts, counts and ids;
    # chans, logt and exit_k written once
    nbytes = (total * (nc + 8) * 4 + 3 * t * 4 + t * (nc + 1) * p * 4
              + t * p * 4 + t * 4)
    return ops, nbytes


def b2_work(records, starts, counts, exit_k, geom, min_alpha):
    """(ops, bytes) of B2's function on these records: B1's visits walked
    twice and the gradient terms of the contributing visits."""
    c, total = visit_counts(records, starts, counts, exit_k, geom,
                            min_alpha)
    nc = records.shape[0] - 8
    ts, _, t = geom
    p = ts * ts
    ops = (2 * tier_ops(c)
           + c["contributing"] * (OPS_B2_REPLAY + OPS_B2_GRAD_BASE
                                  + OPS_B2_GRAD_PER_CHANNEL * nc)
           + int(exit_k.long().sum()) * p * OPS_B2_CHUNK)
    # records of the pairs replayed, gchans and logt read once; starts,
    # counts, ids and exit_k; the [NC + 8, S] gradient written once
    nbytes = (total * (nc + 8) * 4 + t * (nc + 1) * p * 4 + t * p * 4
              + 4 * t * 4 + records.numel() * 4)
    return ops, nbytes


def surfel_visit_counts(records, starts, counts, exit_k, geom, min_alpha):
    """B3's visits before the exit: in the box, past the |p.z| and depth
    cuts, contributing; and the pairs visited."""
    ts, tiles_x, tiles_total = geom
    dev = records.device
    tile, slot, total = visited_slots(starts, counts, exit_k, tiles_total)
    pix = torch.arange(ts, device=dev, dtype=torch.float32) + 0.5
    nc = records.shape[0] - 14
    out = {"pairs": total, "visits": total * ts * ts, "in_box": 0,
           "past_cuts": 0, "contributing": 0}
    step = WORK_PAIRS_PER_STEP // 4
    for i in range(0, total, step):
        r = records[:, slot[i:i + step]]
        x0, y0 = _tile_origin(tile[i:i + step], ts, tiles_x)
        px = (x0[:, None] + pix[None, :])[:, None, :]              # [B, 1, x]
        py = (y0[:, None] + pix[None, :])[:, :, None]              # [B, y, 1]
        f = [v[:, None, None] for v in r]
        dx, dy = px - f[9], py - f[10]
        in_box = (dx.abs() <= f[12 + nc]) & (dy.abs() <= f[13 + nc])
        k = [px * f[2 + 3 * j] - f[3 * j] for j in range(3)]
        l_ = [py * f[2 + 3 * j] - f[1 + 3 * j] for j in range(3)]
        p0 = k[1] * l_[2] - k[2] * l_[1]
        p1 = k[2] * l_[0] - k[0] * l_[2]
        p2 = k[0] * l_[1] - k[1] * l_[0]
        tiny = p2.abs() < 1e-12
        sp2 = torch.where(tiny, torch.full_like(p2, 1e-12), p2)
        su, sv = p0 / sp2, p1 / sp2
        rho3d = su * su + sv * sv
        rho2d = 2.0 * (dx * dx + dy * dy)
        use3d = rho3d <= rho2d
        depth = torch.where(use3d, su * f[2] + sv * f[5] + f[8],
                            f[8].expand_as(su))
        past = in_box & ~tiny & ~(depth < SURFEL_NEAR)
        rho = torch.where(use3d, rho3d, rho2d)
        alpha = torch.clamp(f[11 + nc] * torch.exp(-0.5 * rho),
                            max=SURFEL_ALPHA_MAX)
        out["in_box"] += int(in_box.sum())
        out["past_cuts"] += int(past.sum())
        out["contributing"] += int((past & (alpha >= min_alpha)).sum())
    return out, total


def surfel_tier_ops(counts):
    return (counts["pairs"] * OPS_PAIR_TILE
            + counts["in_box"] * SURF_OPS_IN_BOX
            + counts["past_cuts"] * SURF_OPS_PAST_CUTS)


def b3_work(records, starts, counts, exit_k, geom, min_alpha):
    """(ops, bytes) of B3's function on these records."""
    c, total = surfel_visit_counts(records, starts, counts, exit_k, geom,
                                   min_alpha)
    nc = records.shape[0] - 14
    ts, _, t = geom
    p = ts * ts
    ops = surfel_tier_ops(c) + c["contributing"] * (SURF_OPS_BLEND_BASE
                                                    + 2 * nc)
    # records of the pairs composited, read once; starts, counts and ids;
    # colors, logt and exit_k written once
    nbytes = (total * (nc + 14) * 4 + 3 * t * 4 + t * p * nc * 4 + t * p * 4
              + t * 4)
    return ops, nbytes


def b4_work(records, starts, counts, exit_k, geom, min_alpha):
    """(ops, bytes) of B4's function on these records: B3's visits walked
    twice and the gradient terms of the contributing visits."""
    c, total = surfel_visit_counts(records, starts, counts, exit_k, geom,
                                   min_alpha)
    nc = records.shape[0] - 14
    ts, _, t = geom
    p = ts * ts
    ops = (2 * surfel_tier_ops(c)
           + c["contributing"] * (OPS_B4_GRAD_BASE
                                  + OPS_B4_GRAD_PER_CHANNEL * nc)
           + int(exit_k.long().sum()) * p * OPS_B2_CHUNK)
    # records of the pairs replayed, gcol, glogt and logt read once; starts,
    # counts, ids and exit_k; the [NC + 14, S] gradient written once
    nbytes = (total * (nc + 14) * 4 + t * p * nc * 4 + 2 * t * p * 4
              + 4 * t * 4 + records.numel() * 4)
    return ops, nbytes


# Per-splat float32 operations of the projection (an FMA counts two), from
# the formulas of the 3D projection for one splat in view: view transform
# (3 x 3 FMA + 3 add = 21), clip transform of 4 rows (4 x 8 = 32), cull
# (8), divide and viewport (6); scale exp (3), quaternion normalise (12),
# rotation (30), covariance entries (6 x 9 = 54), Jacobian rows (14), the
# three quadratic forms (3 x 30 = 90), dilation, determinant, eigen cull
# (14), conic (6); SH direction and normalise (12), SH bands by degree
# (degree 1: 3 x 8, degree 2: a further 3 x 22 + 12), clamp (6); opacity
# sigmoid (4), the box (12).
PROJ_OPS_BASE = 21 + 32 + 8 + 6 + 3 + 12 + 30 + 54 + 14 + 90 + 14 + 6 + 12 \
    + 6 + 4 + 12
PROJ_OPS_SH = {0: 0, 1: 24, 2: 24 + 66 + 12}
# The 2D projection: view and clip (53), cull (8), scale exp (3),
# quaternion normalise (12), the two tangent columns (24), T (3 rows x 3 x
# 8 = 72), distance, centre and extents (40), box (8); SH and opacity as
# the 3D projection's.
PROJ2D_OPS_BASE = 53 + 8 + 3 + 12 + 24 + 72 + 40 + 8 + 12 + 6 + 4
# A reverse pass takes about twice its forward's operations.
BACKWARD_FACTOR = 2


def projection_ops(splats_in_view: int, sh_degree: int, mode_2d: bool,
                   backward: bool) -> int:
    base = PROJ2D_OPS_BASE if mode_2d else PROJ_OPS_BASE
    fwd = splats_in_view * (base + PROJ_OPS_SH[sh_degree])
    return fwd * (1 + BACKWARD_FACTOR) if backward else fwd
