"""Shared pieces of the port's tests (tests/test_torch_*.py): scenes made
with numpy from a seed and fed to both packages, error-mass measures, the
fixture that decides at test time whether a CUDA card is present, and the
one that runs the JAX package's Pallas kernels in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import gaussiansplats3d_tpu as gs
import gaussiansplats3d_tpu_torch as gt
from gaussiansplats3d_tpu.render import pallas_rasterize as pr
from torch_scenes import scene_arrays  # noqa: F401

# Six xdist workers share the machine.
torch.set_num_threads(2)


def both_scenes(arrays, device="cpu"):
    """The same splats as a JAX SplatData and a port SplatData."""
    return (gs.SplatData(*(jnp.asarray(a) for a in arrays)),
            gt.SplatData.from_numpy(*arrays, device=device))


def both_cameras(cam_j, device="cpu"):
    """A JAX camera and the port's copy of its matrices."""
    return cam_j, gt.Camera.from_numpy(np.asarray(cam_j.view),
                                       np.asarray(cam_j.proj),
                                       np.asarray(cam_j.cam_pos),
                                       device=device)


def edge_pairs(cfg, seed, n=3000):
    """Random pairs for the backward compositors' per-warp cull: numpy
    float32 centres x, y, box half-widths rx, ry (pixels, the image's
    coordinates) and int64 tile ids, n each.  Half the boxes are under a
    pixel (rx, ry < 1).  On each axis a third of the centres sit within
    1e-3 px of an edge of a random warp's rectangle
    (cuda_rasterize.warp_rects), a third put their box's edge there, the
    rest lie anywhere over the tile and 3 px around it.  At sides above 32,
    where the kernels hold a tile as four 32 x 32 quadrants (33-64) or walk
    its 32 x 32 sub-tiles (above 64), a quarter of the centres on each axis
    then move to within their box's half-width of a seam between them (a
    multiple of 32 inside the tile), so that their boxes cross it."""
    from gaussiansplats3d_tpu_torch.render import cuda_rasterize as cr
    rng = np.random.default_rng(seed)
    ts = cfg.tile_size
    rects = cr.warp_rects(cfg).numpy()
    tile = rng.integers(0, cfg.num_tiles, n)
    corner = np.stack([tile % cfg.tiles_x, tile // cfg.tiles_x], 1) * ts
    r = np.where(rng.random((n, 2)) < 0.5, rng.uniform(0.05, 1.0, (n, 2)),
                 rng.uniform(1.0, 6.0, (n, 2)))
    c = rng.uniform(-3.0, ts + 3.0, (n, 2))
    w = rng.integers(0, rects.shape[0], n)
    for axis in (0, 1):
        edge = np.where(rng.random(n) < 0.5, rects[w, 2 * axis],
                        rects[w, 2 * axis + 1])
        jitter = rng.uniform(-1e-3, 1e-3, n)
        sign = np.where(rng.random(n) < 0.5, -1.0, 1.0)
        which = rng.integers(0, 3, n)
        c[:, axis] = np.select([which == 1, which == 2],
                               [edge + jitter,
                                edge + sign * r[:, axis] + jitter],
                               c[:, axis])
    if ts > 32:
        # the seams between quadrants (sides 33-64) or sub-tiles (above 64)
        g = -(-ts // 32)
        for axis in (0, 1):
            seam = rng.random(n) < 0.25
            at = 32.0 * rng.integers(1, g, n) if g > 2 else 32.0
            c[:, axis] = np.where(
                seam, at + rng.uniform(-1.0, 1.0, n) * r[:, axis],
                c[:, axis])
    xy = (corner + c).astype(np.float32)
    r = r.astype(np.float32)
    return xy[:, 0], xy[:, 1], r[:, 0], r[:, 1], tile


def edge_windows(tile, num_tiles, gap=37):
    """Slots for pairs grouped by tile, each tile's window starting `gap`
    slots after the previous one ends (so windows start mid-chunk):
    (slot of each pair, starts, counts int32 [num_tiles], capacity S, a
    multiple of 128)."""
    n = tile.shape[0]
    counts = np.bincount(tile, minlength=num_tiles)
    starts = np.cumsum(counts + gap) - counts
    order = np.argsort(tile, kind="stable")
    first = np.cumsum(counts) - counts
    slot = np.empty(n, np.int64)
    slot[order] = starts[tile[order]] + np.arange(n) - first[tile[order]]
    cap = -(-int(starts[-1] + counts[-1]) // 128) * 128
    return slot, starts.astype(np.int32), counts.astype(np.int32), cap


def edge_records(cfg, seed, device):
    """Records built by hand over 2 x 2 tiles (edge_pairs at B2's warp
    rectangles), in windows that start mid-chunk: flat Gaussians whose
    box edge is at g = 1, random colours and opacities 0.3-0.9."""
    x, y, rx, ry, tile = edge_pairs(cfg, seed, n=1200)
    slot, starts, counts, cap = edge_windows(tile, cfg.num_tiles)
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    rec = np.zeros((11, cap), np.float32)
    a, c = 0.5 / rx ** 2, 0.5 / ry ** 2
    rec[:, slot] = np.stack([
        x, y, a, 0.2 * np.sqrt(a * c) * rng.uniform(-1.0, 1.0, n), c,
        *rng.uniform(0.0, 1.0, (3, n)), rng.uniform(0.3, 0.9, n), rx, ry])
    return (torch.tensor(rec, device=device),
            torch.tensor(starts, device=device),
            torch.tensor(counts, device=device),
            torch.arange(cfg.num_tiles, dtype=torch.int32, device=device))


# The walk's second-pass case: one tile of side 128 at the origin whose
# sub-tile (2, 2) (the 11th of 16, pixels 64-95 on both axes) outlives
# the others.
WALK_TILE, WALK_SUB = 128, 10


def walk_exit_boxes(seed=13):
    """Slots 0..299: pairs of opacity 0.97 whose boxes cover the four
    rectangles around sub-tile (2, 2) in turn (32 a rectangle in chunk 0:
    every other pixel's T dies there, below exp(CS_FLOOR)); slots
    300..799: pairs of opacity 0.015-0.025 whose boxes cover that sub-tile
    alone, so its T falls under 1e-4 only after ~450 of them, in chunk 5.
    Every box is flat: alpha is the opacity wherever the box holds the
    pixel centre.  Returns numpy float32 (cx, cy, rx, ry, opacity, rgb [3,
    n]) and the window (starts, counts) int32, capacity 896."""
    rng = np.random.default_rng(seed)
    # (cx, cy, rx, ry): rows 0-63; rows 96-127; rows 64-95 left and right
    rects = np.array([[64.0, 32.0, 64.0, 31.6], [64.0, 112.0, 64.0, 15.6],
                      [32.0, 80.0, 31.6, 15.6], [112.0, 80.0, 15.6, 15.6]],
                     np.float32)
    box = np.concatenate([rects[np.arange(300) % 4],
                          np.tile([[80.0, 80.0, 15.6, 15.6]], (500, 1))])
    opa = np.concatenate([np.full(300, 0.97),
                          rng.uniform(0.015, 0.025, 500)])
    rgb = rng.uniform(0.0, 1.0, (3, 800))
    cx, cy, rx, ry = box.T.astype(np.float32)
    return ((cx, cy, rx, ry, opa.astype(np.float32), rgb.astype(np.float32)),
            (np.array([0], np.int32), np.array([800], np.int32)))


def walk_exit_records(device):
    """walk_exit_boxes as B1's records [11, 896] (conic 1e-8: g ~ 0), with
    its window and tile id 0 on ``device``."""
    (cx, cy, rx, ry, opa, rgb), (starts, counts) = walk_exit_boxes()
    rec = np.zeros((11, 896), np.float32)
    flat = np.full_like(cx, 1e-8)
    rec[:, :800] = np.stack([cx, cy, flat, 0.0 * flat, flat, *rgb, opa, rx,
                             ry])
    return (torch.tensor(rec, device=device),
            torch.tensor(starts, device=device),
            torch.tensor(counts, device=device),
            torch.zeros(1, dtype=torch.int32, device=device))


def cull_case(cfg, seed):
    """The per-pixel box test against the per-warp cull's plain mirror on
    :func:`edge_pairs`: (hit, keep), [n, W] bool each.  hit: some pixel of
    the warp passes |p - c| <= r, float32 as the kernels compute it;
    keep: ``cuda_rasterize.kept_pair_warps``' predicate."""
    from gaussiansplats3d_tpu_torch.render import cuda_rasterize as cr
    x, y, rx, ry, tile = (torch.from_numpy(a) for a in
                          edge_pairs(cfg, seed))
    ts = cfg.tile_size
    npix = ts * ts
    rects = cr.warp_rects(cfg)
    tx, ty = cr.tile_origins(tile, cfg)
    p = torch.arange(npix)
    px = tx[:, None] + (p % ts).float() + 0.5                   # [n, P]
    py = ty[:, None] + (p // ts).float() + 0.5
    in_box = ((px - x[:, None]).abs() <= rx[:, None]) & (
        (py - y[:, None]).abs() <= ry[:, None])
    # a warp's pixels are the tile's pixels inside its rectangle
    pcx, pcy = (p % ts).float() + 0.5, (p // ts).float() + 0.5
    hit = torch.stack([
        in_box[:, (pcx >= r[0]) & (pcx <= r[1]) & (pcy >= r[2])
               & (pcy <= r[3])].any(dim=1) for r in rects], dim=1)
    keep = cr.warp_keep(x[:, None], y[:, None], rx[:, None], ry[:, None],
                        tx[:, None] + rects[:, 0], tx[:, None] + rects[:, 1],
                        ty[:, None] + rects[:, 2], ty[:, None] + rects[:, 3])
    return hit, keep


def error_mass(a, b, bar=1e-2):
    """(p99.9 of |a - b|, share of elements with |a - b| > bar)."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(np.quantile(d, 0.999)), float(np.mean(d > bar))


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip: decided when the test runs, never at
    import time, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run pallas_call in interpret mode, as tests/test_pallas.py does."""
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pr.pl, "pallas_call", patched)
