"""Kernels B1 and B2 of the port (render/cuda_rasterize.py): their plain
PyTorch versions against the JAX package's Pallas _composite_fwd and
_composite_bwd (run in interpret mode, as tests/test_pallas.py runs them)
and rasterize_pairs, on records the JAX package's bin_sort_records produced
(f32 precision, so the records are exact); and, on a card, the CUDA kernels
against their plain versions.

Bars.  B1: chans max |d| < 4e-3 (test_pallas.py's bar: the Pallas kernel's
2-limb bf16 prefix scan and the early exit truncate below T ~ 1e-4);
exit_k equal on >= 99% of tiles; log T p99.9 |d| <= 1e-3.  B2, per record
row, |d| normalised by the row's max |reference|: p99.9 <= 5e-3 against
the Pallas kernel (test_pallas.py:103's bar: its 2- and 3-limb bf16
matmuls), <= 1e-2 against rasterize_pairs (no early exit, so the tail
below T ~ 1e-4 differs).  On the card: B1 by error mass, p99.9 |d| <= 1e-3
and <= 0.1% of elements over 1e-2; B2 normalised p99.9 <= 1e-3 and <= 0.1%
of elements over 1e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussiansplats3d_tpu as gs
import gaussiansplats3d_tpu_torch as gt
from gaussiansplats3d_tpu.render import binning as bin_j
from gaussiansplats3d_tpu.render import pallas_rasterize as pr
from gaussiansplats3d_tpu.render import projection as proj_j
from gaussiansplats3d_tpu.render import rasterize
from gaussiansplats3d_tpu.render.pipeline import chans_from_colors_logt
from gaussiansplats3d_tpu_torch.render import cuda_rasterize as cr
from gaussiansplats3d_tpu_torch.utils import metrics

from torch_port_common import (WALK_SUB, WALK_TILE, both_scenes,  # noqa: F401
                               cuda_device, cull_case, edge_pairs,
                               edge_records, error_mass, interpret_pallas,
                               scene_arrays, walk_exit_records)


# one compilation per configuration instead of op-by-op dispatch (the
# records feed both compositors, so their last bits need not be the eager
# path's)
project_j = jax.jit(proj_j.project_splats, static_argnums=(2,))
bin_sort_j = jax.jit(bin_j.bin_sort_records, static_argnums=(1,))


def jax_binned(n=800, width=96, height=96, depth=False, seed=31,
               scale_mul=1.0):
    """(cfg_j, cfg_t, JAX SortedPairs, port-layout records [NC + 8, S])."""
    arrays = scene_arrays(n, sh_degree=0, seed=seed, scale_mul=scale_mul)
    s_j, _ = both_scenes(arrays)
    cam = gs.Camera.look_at((2.5, 1.5, 2.5), (0, 0, 0), fov_y_deg=60,
                            aspect=width / height)
    kw = dict(width=width, height=height, record_precision="f32",
              return_depth=depth)
    cfg_j = gs.RenderConfig(**kw)
    pairs = bin_sort_j(project_j(s_j, cam, cfg_j), cfg_j)
    rows = [pairs.xs, pairs.ys, pairs.cas, pairs.cbs, pairs.ccs, pairs.crs,
            pairs.cgs, pairs.cbs2] + ([pairs.depths] if depth else []) + [
        pairs.opas, pairs.rxs, pairs.rys]
    records = np.stack([np.asarray(r) for r in rows])
    return cfg_j, gt.RenderConfig(**kw), pairs, records


def norm_err(a, b):
    """Per row of [R, S] gradients: (p99.9 of |a - b| / max |b|, share of
    elements with that ratio over 1e-2); rows where b is all 0 must be 0."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    out = []
    for ra, rb in zip(a, b):
        scale = np.abs(rb).max()
        if scale == 0.0:
            assert np.abs(ra).max() == 0.0
            out.append((0.0, 0.0))
            continue
        out.append(error_mass(ra / scale, rb / scale))
    return out


def pallas_bwd(cfg_j, pairs, rec16, gch, t):
    """grad of sum(chans * gch) through the interpret-mode Pallas
    compositor: [16, S] in the record layout."""
    def f(r):
        return jnp.sum(pr.composite_tiles(
            cfg_j, pairs.capacity, r, pairs.tile_starts, pairs.tile_counts,
            jnp.arange(t, dtype=jnp.int32)) * gch)
    return np.asarray(jax.grad(f)(rec16))


def port_inputs(pairs, records, device="cpu"):
    t = pairs.tile_starts.shape[0]
    return (torch.tensor(records, device=device),
            torch.tensor(np.asarray(pairs.tile_starts), device=device),
            torch.tensor(np.asarray(pairs.tile_counts), device=device),
            torch.arange(t, dtype=torch.int32, device=device))


@pytest.mark.parametrize("route", [
    "plain", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("depth", [False, True])
def test_b1_matches_interpret_pallas(interpret_pallas, request, depth, route):
    """The plain version on the CPU, or the CUDA kernel on a card, against
    the Pallas kernel."""
    device = request.getfixturevalue("cuda_device") if route == "cuda" \
        else "cpu"
    cfg_j, cfg_t, pairs, records = jax_binned(depth=depth)
    t = cfg_j.num_tiles
    rec16 = pr.pack_records_flat(
        pairs.xs, pairs.ys, pairs.cas, pairs.cbs, pairs.ccs, pairs.crs,
        pairs.cgs, pairs.cbs2, pairs.opas, pairs.rxs, pairs.rys,
        depths=pairs.depths if depth else None)
    chans_p, res = pr._composite_fwd(cfg_j, pairs.capacity, rec16,
                                     pairs.tile_starts, pairs.tile_counts,
                                     jnp.arange(t, dtype=jnp.int32))
    logt_p, exit_p = np.asarray(res[4])[:t, :, 0], np.asarray(res[5])[:t]
    chans, logt, exit_k = (x.cpu().numpy() for x in cr.composite_fwd(
        *port_inputs(pairs, records, device), cfg_t))
    assert float(np.abs(chans - np.asarray(chans_p)).max()) < 4e-3
    assert np.mean(exit_k == exit_p) >= 0.99
    assert error_mass(logt, logt_p)[0] <= 1e-3
    assert int(exit_k.max()) >= 2          # several chunks composited


def test_plain_b1_matches_jax_rasterize_pairs():
    # the shapes of jax_binned()'s default scene, so its JAX compilations
    # are reused; another seed
    cfg_j, cfg_t, pairs, records = jax_binned(seed=32)
    chans, _, _ = cr.composite_fwd_torch(*port_inputs(pairs, records), cfg_t)
    chans_j = chans_from_colors_logt(*rasterize.rasterize_pairs(
        cfg_j, pairs.capacity, jnp.stack([pairs.xs, pairs.ys], axis=1),
        jnp.stack([pairs.cas, pairs.cbs, pairs.ccs], axis=1),
        jnp.stack([pairs.crs, pairs.cgs, pairs.cbs2], axis=1), pairs.opas,
        jnp.stack([pairs.rxs, pairs.rys], axis=1), pairs.tile_starts,
        pairs.tile_counts, 0))
    # rasterize_pairs has no early exit: the tail below T ~ 1e-4 differs
    assert float(np.abs(chans.numpy() - np.asarray(chans_j)).max()) < 4e-3


def test_early_exit_and_unaligned_windows():
    """A stack of near-opaque pairs over one tile exits after the first
    chunk; a window starting mid-chunk reads a floor-aligned chunk."""
    cfg = gt.RenderConfig(width=32, height=32, tile_size=16)
    s = 512
    rec = torch.zeros((11, s))
    rec[0], rec[1] = 8.0, 8.0                      # centre of tile 0
    rec[2], rec[4] = 1e-4, 1e-4                    # very flat Gaussians
    rec[5:8] = 0.5
    rec[8] = 0.99
    rec[9], rec[10] = 100.0, 100.0
    starts = torch.tensor([0, 200, 300, 512], dtype=torch.int32)
    counts = torch.tensor([300, 50, 0, 0], dtype=torch.int32)
    ids = torch.arange(4, dtype=torch.int32)
    chans, logt, exit_k = cr.composite_fwd(rec, starts, counts, ids, cfg)
    # tile 0: 128 pairs of alpha 0.99 kill every pixel in chunk 0
    assert exit_k.tolist() == [1, 1, 1, 0]
    np.testing.assert_allclose(chans[0, 3].numpy(), 1.0, atol=1e-6)
    assert float(logt[0].max()) < -9.2
    # tile 1 reads chunk 1 (slots 128..255) but only its window 200..249
    # holds pairs; their centre sits in tile 0, 8 px left of tile 1
    assert float(chans[1, 3].min()) > 0.99
    assert float(chans[2].abs().max()) == 0.0      # count 0, one chunk read
    assert float(chans[3].abs().max()) == 0.0


def _exit_records():
    """Tile 0: 300 near-opaque pairs at slots 0..299, which kill every
    pixel in chunk 0 (exit_k 1: chunks 1 and 2 are never replayed);
    tile 1: a window 300..349 starting mid-chunk 2, the chunk tile 0's
    window ends in; tiles 2 and 3: empty windows off a chunk boundary,
    which still replay one chunk."""
    rng = np.random.default_rng(34)
    rec = np.zeros((11, 512), np.float32)
    rec[0, :300], rec[1, :300] = 8.0, 8.0          # centre of tile 0
    rec[2, :300], rec[4, :300] = 1e-3, 1e-3
    rec[8, :300] = 0.97
    rec[0, 300:350] = rng.uniform(16.0, 32.0, 50)  # over tile 1
    rec[1, 300:350] = rng.uniform(0.0, 16.0, 50)
    rec[2, 300:350] = rng.uniform(0.05, 0.2, 50)
    rec[3, 300:350] = rng.uniform(-0.02, 0.02, 50)
    rec[4, 300:350] = rng.uniform(0.05, 0.2, 50)
    rec[8, 300:350] = rng.uniform(0.2, 0.7, 50)
    rec[5:8, :350] = rng.uniform(0.0, 1.0, (3, 350))
    rec[9:11, :350] = 20.0
    starts = np.array([0, 300, 350, 350], np.int32)
    counts = np.array([300, 50, 0, 0], np.int32)
    return rec, starts, counts


def _pallas_pairs(rec, starts, counts):
    """The synthetic records as the fields pallas_bwd reads."""
    class Pairs:
        capacity = rec.shape[1]
        tile_starts = jnp.asarray(starts)
        tile_counts = jnp.asarray(counts)
    return Pairs, pr.pack_records_flat(*(jnp.asarray(r) for r in rec))


@pytest.mark.parametrize("case", ["scene", "depth", "early_exit",
                                  "shared_chunk"])
def test_plain_b2_matches_interpret_pallas(interpret_pallas, case):
    """The plain B2, replaying the plain B1's residuals, against jax.grad
    through the Pallas kernel: a scene of several chunks a tile, the same
    with a depth channel, an early exit before an unaligned window that
    starts in the exiting tile's last chunk, and many small tiles whose
    windows share one chunk (test_pallas.py:169)."""
    if case == "early_exit":
        cfg_t = gt.RenderConfig(width=32, height=32, tile_size=16)
        cfg_j = gs.RenderConfig(width=32, height=32, tile_size=16)
        records, starts, counts = _exit_records()
        pairs, rec16 = _pallas_pairs(records, starts, counts)
    else:
        kw = dict(n=300, width=160, height=160, seed=13) \
            if case == "shared_chunk" else {}
        cfg_j, cfg_t, pairs, records = jax_binned(depth=case == "depth", **kw)
        rec16 = pr.pack_records_flat(
            pairs.xs, pairs.ys, pairs.cas, pairs.cbs, pairs.ccs, pairs.crs,
            pairs.cgs, pairs.cbs2, pairs.opas, pairs.rxs, pairs.rys,
            depths=pairs.depths if case == "depth" else None)
    t = cfg_t.num_tiles
    inputs = port_inputs(pairs, records)
    chans, logt, exit_k = cr.composite_fwd_torch(*inputs, cfg_t)
    if case == "early_exit":
        assert exit_k.tolist() == [1, 1, 1, 1]
    if case == "shared_chunk":
        st, cn = inputs[1].numpy(), inputs[2].numpy()
        assert ((st // 128 == (st + np.maximum(cn - 1, 0)) // 128)
                & (cn > 0)).sum() >= 8
    gch = np.random.default_rng(35).normal(
        0.0, 0.1, tuple(chans.shape)).astype(np.float32)
    grad = cr.composite_bwd_torch(*inputs, logt, exit_k, torch.tensor(gch),
                                  cfg_t).numpy()
    ref = pallas_bwd(cfg_j, pairs, rec16, jnp.asarray(gch), t)
    nf = grad.shape[0]
    assert np.abs(grad[nf - 2:]).max() == 0.0      # rx, ry: no gradient
    for row, (p999, _) in enumerate(norm_err(grad[:nf - 2],
                                             ref[:nf - 2])):
        assert p999 <= 5e-3, (case, row, p999)
    assert np.abs(grad[:, 350:] if case == "early_exit"
                  else grad[:, int(inputs[1][-1] + inputs[2][-1]):]
                  ).max() == 0.0                   # outside every window
    if case == "early_exit":
        assert np.abs(grad[:, 128:300]).max() == 0.0   # past tile 0's exit
        assert np.abs(grad[:, 300:350]).max() > 0.0


def test_plain_b2_matches_jax_rasterize_pairs():
    cfg_j, cfg_t, pairs, records = jax_binned(seed=36)
    inputs = port_inputs(pairs, records)
    chans, logt, exit_k = cr.composite_fwd_torch(*inputs, cfg_t)
    gch = np.random.default_rng(37).normal(
        0.0, 0.1, tuple(chans.shape)).astype(np.float32)
    grad = cr.composite_bwd_torch(*inputs, logt, exit_k, torch.tensor(gch),
                                  cfg_t).numpy()

    def f(m2, con, col, opa):
        return jnp.sum(chans_from_colors_logt(*rasterize.rasterize_pairs(
            cfg_j, pairs.capacity, m2, con, col, opa,
            jnp.stack([pairs.rxs, pairs.rys], axis=1), pairs.tile_starts,
            pairs.tile_counts, 0)) * jnp.asarray(gch))

    gm, gc, gcl, gop = jax.grad(f, argnums=(0, 1, 2, 3))(
        jnp.stack([pairs.xs, pairs.ys], axis=1),
        jnp.stack([pairs.cas, pairs.cbs, pairs.ccs], axis=1),
        jnp.stack([pairs.crs, pairs.cgs, pairs.cbs2], axis=1), pairs.opas)
    ref = np.concatenate([np.asarray(gm).T, np.asarray(gc).T,
                          np.asarray(gcl).T, np.asarray(gop)[None]])
    for row, (p999, _) in enumerate(norm_err(grad[:9], ref)):
        assert p999 <= 1e-2, (row, p999)


def test_wrapper_cpu_path_checks_and_no_gradient():
    """The CPU path runs the plain versions, forward and backward, and
    launches no kernel; the wrappers check their inputs."""
    cfg = gt.RenderConfig(width=32, height=32, tile_size=16)
    records, starts, counts = _exit_records()
    rec = torch.tensor(records, requires_grad=True)
    starts, counts = torch.tensor(starts), torch.tensor(counts)
    ids = torch.arange(4, dtype=torch.int32)
    before = (metrics.total(cr.LAUNCHES), metrics.total(cr.BWD_LAUNCHES))
    chans, logt, exit_k = cr.composite_tiles(cfg, rec, starts, counts, ids)
    gch = torch.randn(chans.shape, generator=torch.Generator().manual_seed(3))
    (chans * gch).sum().backward()
    # the plain versions count nothing
    assert (metrics.total(cr.LAUNCHES),
            metrics.total(cr.BWD_LAUNCHES)) == before
    np.testing.assert_array_equal(rec.grad.numpy(), cr.composite_bwd(
        rec.detach(), starts, counts, ids, logt, exit_k, gch, cfg).numpy())
    assert float(rec.grad[:9, 300:350].abs().min(dim=1).values.max()) > 0.0
    with pytest.raises(ValueError):
        cr.composite_bwd(rec.detach(), starts, counts, ids, logt,
                         exit_k.long(), gch, cfg)
    with pytest.raises(ValueError):
        cr.composite_bwd_cuda(rec.detach(), starts, counts, ids, logt,
                              exit_k, gch, cfg)
    rec = rec.detach()[:, :128]
    with pytest.raises(ValueError):
        cr.composite_fwd(rec.detach()[:, :100], starts, counts, ids, cfg)
    with pytest.raises(ValueError):
        cr.composite_fwd(rec.detach(), starts.long(), counts, ids, cfg)
    with pytest.raises(ValueError):
        cr.composite_fwd(rec.detach(), starts, counts, ids[:3], cfg)
    with pytest.raises(ValueError):
        cr.composite_fwd_cuda(rec.detach(), starts, counts, ids, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [False, True])
def test_cuda_b2_matches_plain(cuda_device, depth):
    _, cfg_t, pairs, records = jax_binned(n=3000, width=200, height=150,
                                          depth=depth, seed=38)
    inputs = port_inputs(pairs, records, device=cuda_device)
    chans, logt, exit_k = cr.composite_fwd(*inputs, cfg_t)
    gch = 0.1 * torch.randn(chans.shape, device=cuda_device,
                            generator=torch.Generator(cuda_device).manual_seed(4))
    before = metrics.total(cr.BWD_LAUNCHES)
    grad = cr.composite_bwd(*inputs, logt, exit_k, gch, cfg_t)
    torch.cuda.synchronize()
    assert metrics.total(cr.BWD_LAUNCHES) == before + 1
    ref = cr.composite_bwd_torch(*inputs, logt, exit_k, gch, cfg_t)
    for p999, over in norm_err(grad.cpu().numpy(), ref.cpu().numpy()):
        assert p999 <= 1e-3 and over <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [False, True])
def test_cuda_b1_matches_plain(cuda_device, depth):
    _, cfg_t, pairs, records = jax_binned(n=3000, width=200, height=150,
                                          depth=depth, seed=33)
    assert_cuda_b1_matches_plain(
        cfg_t, port_inputs(pairs, records, device=cuda_device))


@pytest.mark.parametrize("tile", [12, 16, 20, 32, 40, 64, 96, 128])
def test_warp_cull_mirror_keeps_every_box_hit(tile):
    """The plain mirror of B1's and B2's per-warp cull (warp_keep over
    their warp rectangles) keeps every pair that passes the per-pixel box
    test at some pixel of the warp, on pairs whose centres or box edges sit
    within 1e-3 px of a warp rectangle's edge, half of them with boxes
    under a pixel, also where a tile's edge cuts the warps' patches and (at
    40 and 64) on boxes across the quadrant seams, (at 96 and 128) across
    the seams of the sub-tiles a block walks; it drops some;
    kept_pair_warps counts what it keeps."""
    cfg = gt.RenderConfig(width=2 * tile, height=2 * tile, tile_size=tile)
    hit, keep = cull_case(cfg, seed=40 + tile)
    assert bool(hit.any()) and bool((~keep).any())
    assert int((hit & ~keep).sum()) == 0
    x, y, rx, ry, t = (torch.from_numpy(a) for a in
                       edge_pairs(cfg, seed=40 + tile))
    assert torch.equal(cr.kept_pair_warps(x, y, rx, ry, t, cfg),
                       keep.sum(dim=1))


@pytest.mark.parametrize("tile", [8, 12, 16, 20, 24, 32])
def test_warp_rects_tile_the_tile(tile):
    """warp_rects, the mirror of B1-B4's pixel layout (csrc/warp_cull.cuh),
    covers every pixel centre of the tile in exactly one warp's rectangle,
    with as many warps as the kernels launch: 8 x 8 patches, cut at the
    tile's edge where the side is no multiple of 8, at most 16 warps (512
    threads) at tile 32."""
    cfg = gt.RenderConfig(width=tile, height=tile, tile_size=tile)
    rects = cr.warp_rects(cfg)
    across = -(-tile // cr.WARP_PATCH)
    assert rects.shape == (across * across, 4)
    assert rects.shape[0] * 32 * 2 >= tile * tile and rects.shape[0] <= 16
    c = torch.arange(tile, dtype=torch.float32) + 0.5
    px, py = c[None, :].expand(tile, tile), c[:, None].expand(tile, tile)
    inside = ((px[None] >= rects[:, 0, None, None])
              & (px[None] <= rects[:, 1, None, None])
              & (py[None] >= rects[:, 2, None, None])
              & (py[None] <= rects[:, 3, None, None]))
    assert torch.equal(inside.sum(dim=0), torch.ones(tile, tile,
                                                     dtype=torch.long))
    assert float((rects[:, 1] - rects[:, 0]).max()) == cr.WARP_PATCH - 1


@pytest.mark.parametrize("tile", [33, 36, 40, 48, 64, 65, 96, 128, 200])
def test_quadrant_patches_are_the_warp_rects(tile):
    """At sides 33-64 the kernels hold a tile as a cluster of four blocks,
    block r on the 32 x 32 quadrant (r % 2, r / 2), and above 64 one block
    walks the g x g sub-tiles of 32 x 32 (g = ceil(side / 32)), sub-tile s
    at (s % g, s / g); on each, 16 warps on 8 x 8 patches row-major from
    its corner (csrc/warp_cull.cuh: patch, held, rect).  The patches that
    hold a pixel, clipped to the tile, are exactly warp_rects' (the mirror
    the work counts and tests use), each once; the others lie wholly past
    the tile's edge."""
    cfg = gt.RenderConfig(width=tile, height=tile, tile_size=tile)
    g = 2 if tile <= 64 else -(-tile // 32)
    held = []
    for quad in range(g * g):
        for warp in range(16):
            c0 = quad % g * 32 + warp % 4 * cr.WARP_PATCH
            r0 = quad // g * 32 + warp // 4 * cr.WARP_PATCH
            if c0 < tile and r0 < tile:
                held.append((c0 + 0.5, min(c0 + cr.WARP_PATCH, tile) - 0.5,
                             r0 + 0.5, min(r0 + cr.WARP_PATCH, tile) - 0.5))
    mirror = sorted(tuple(r) for r in cr.warp_rects(cfg).tolist())
    assert sorted(held) == mirror
    assert len(set(held)) == len(held) == (-(-tile // cr.WARP_PATCH)) ** 2


@pytest.mark.parametrize("tile", [64, 65, 128])
@pytest.mark.parametrize("wrapper", ["b1", "b2", "b3", "b4", "b5"])
def test_cuda_wrappers_take_every_side(wrapper, tile):
    """Each CUDA compositor's wrapper takes every side (a cluster of four
    32 x 32 blocks at 64, one block walking 32 x 32 sub-tiles at 65 and
    128): on CPU tensors the one thing it refuses is the device, with a
    ValueError that asks for CUDA tensors; the plain versions render the
    same inputs."""
    from gaussiansplats3d_tpu_torch.render import cuda_surfel as cs
    from gaussiansplats3d_tpu_torch.tools import kernel_bench as kb
    cfg = gt.RenderConfig(width=2 * tile, height=tile, tile_size=tile)
    p = tile * tile
    ids = torch.arange(2, dtype=torch.int32)
    starts = torch.tensor([0, 128], dtype=torch.int32)
    counts = torch.zeros(2, dtype=torch.int32)
    exit_k = torch.zeros(2, dtype=torch.int32)
    logt = torch.zeros(2, p)
    rec11, rec17 = torch.zeros(11, 256), torch.zeros(17, 256)
    call = {
        "b1": lambda: cr.composite_fwd_cuda(rec11, starts, counts, ids, cfg),
        "b2": lambda: cr.composite_bwd_cuda(
            rec11, starts, counts, ids, logt, exit_k, torch.zeros(2, 4, p),
            cfg),
        "b3": lambda: cs.composite_surfel_fwd_cuda(rec17, starts, counts,
                                                   ids, cfg),
        "b4": lambda: cs.composite_surfel_bwd_cuda(
            rec17, starts, counts, ids, logt, exit_k, torch.zeros(2, p, 3),
            logt, cfg),
        "b5": lambda: kb.variant_cuda(rec11, starts, counts, ids, cfg,
                                      "full")}[wrapper]
    with pytest.raises(ValueError, match="needs CUDA tensors$"):
        call()
    plain = {"b1": cr.composite_fwd, "b3": cs.composite_surfel_fwd}.get(
        wrapper)
    if plain is not None:
        out = plain(rec11 if wrapper == "b1" else rec17, starts, counts, ids,
                    cfg)
        assert torch.equal(out[2], exit_k)


def _c_argtypes(symbol):
    """The ctypes of the parameters of ``csrc/``'s ``extern "C"`` entry
    point ``symbol``, read from its source."""
    import ctypes
    import re

    from gaussiansplats3d_tpu_torch import _build
    text = "".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    params = re.search(rf'extern "C" int {symbol}\((.*?)\)\s*\{{', text,
                       re.S).group(1).split(",")
    return tuple(ctypes.c_void_p if "*" in q
                 else ctypes.c_longlong if "long long" in q
                 else ctypes.c_float if "float" in q else ctypes.c_int
                 for q in params)


@pytest.mark.parametrize("lib", ["composite_fwd", "composite_bwd",
                                 "surfel_fwd", "surfel_bwd", "kernel_bench",
                                 "gather_bwd"])
def test_each_kernel_declared_once_and_refuses_cpu(lib):
    """Each kernel library is declared exactly once through the launch
    seam (render/launch.py), with its C signature as csrc/ writes it, its
    launch counter and the launches a call makes; its ``*_cuda`` wrapper
    refuses CPU tensors with a ValueError that asks for CUDA tensors and
    launches nothing."""
    import ast
    from pathlib import Path

    from gaussiansplats3d_tpu_torch import _build
    from gaussiansplats3d_tpu_torch.render import binning
    from gaussiansplats3d_tpu_torch.render import cuda_surfel as cs
    from gaussiansplats3d_tpu_torch.render import launch
    from gaussiansplats3d_tpu_torch.tools import kernel_bench as kb
    assert set(launch.DECLARED) == set(_build.KERNELS)
    pkg = Path(gt.__file__).parent
    declared = [node.args[0].value for p in pkg.rglob("*.py")
                for node in ast.walk(ast.parse(p.read_text()))
                if isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "Kernel"]
    assert declared.count(lib) == 1
    k = launch.DECLARED[lib]
    assert k.argtypes == _c_argtypes(k.symbol)
    cfg = gt.RenderConfig(width=64, height=32, tile_size=32)
    ids = torch.arange(2, dtype=torch.int32)
    starts = torch.tensor([0, 128], dtype=torch.int32)
    counts = torch.zeros(2, dtype=torch.int32)
    exit_k, logt = torch.zeros(2, dtype=torch.int32), torch.zeros(2, 1024)
    rec11, rec17 = torch.zeros(11, 256), torch.zeros(17, 256)
    layout = binning.SlotLayout(n=4, lanes=1, aux_cap=0, pad=124)
    counter, launches, call = {
        "composite_fwd": (cr.LAUNCHES, 1, lambda: cr.composite_fwd_cuda(
            rec11, starts, counts, ids, cfg)),
        "composite_bwd": (cr.BWD_LAUNCHES, 1, lambda: cr.composite_bwd_cuda(
            rec11, starts, counts, ids, logt, exit_k, torch.zeros(2, 4, 1024),
            cfg)),
        "surfel_fwd": (cs.LAUNCHES, 1, lambda: cs.composite_surfel_fwd_cuda(
            rec17, starts, counts, ids, cfg)),
        "surfel_bwd": (cs.BWD_LAUNCHES, 1,
                       lambda: cs.composite_surfel_bwd_cuda(
                           rec17, starts, counts, ids, logt, exit_k,
                           torch.zeros(2, 1024, 3), logt, cfg)),
        "kernel_bench": (kb.LAUNCHES, 1, lambda: kb.variant_cuda(
            rec11, starts, counts, ids, cfg, "full")),
        "gather_bwd": (binning.LAUNCHES, 2, lambda: binning.gather_bwd_cuda(
            torch.zeros(11, 128), torch.arange(128), layout))}[lib]
    assert (k.counter, k.launches) == (counter, launches)
    before = metrics.total(counter)
    with pytest.raises(ValueError, match="needs CUDA tensors$"):
        call()
    assert metrics.total(counter) == before


def test_walk_exits_of_the_second_pass_records():
    """The records of the walk's second-pass case (walk_exit_records), on
    the plain B1: the tile exits after chunk 6 of 7, the exit of sub-tile
    (2, 2) alone; every other sub-tile's own exit is chunk 1, so the walk
    runs the 10 sub-tiles before it a second time (walk_exits)."""
    cfg = gt.RenderConfig(width=WALK_TILE, height=WALK_TILE,
                          tile_size=WALK_TILE)
    inputs = walk_exit_records("cpu")
    _, logt, exit_k = cr.composite_fwd(*inputs, cfg)
    k_sub, second = cr.walk_exits(cr.composite_fwd_torch, *inputs, cfg)
    assert exit_k.tolist() == [6]
    assert k_sub[0, WALK_SUB] == 6 and second.tolist() == [WALK_SUB]
    assert set(k_sub[0].tolist()) == {1, 6}
    # T died below the floor outside the sub-tile: B2 replays there
    assert float(logt.min()) < cr.CS_FLOOR


def port_pairs(device, tile, seed, big=0.0, n=3000, width=200, height=150):
    """The port's own f32 records of a numpy-made scene, binned on
    ``device`` at tile size ``tile``, the first ``big`` share of the splats
    scaled x20: (cfg, (records, starts, counts, tile ids))."""
    from gaussiansplats3d_tpu_torch.render.binning import bin_sort_records
    from gaussiansplats3d_tpu_torch.render.projection import project_splats
    means, scales, *rest = scene_arrays(n, sh_degree=0, seed=seed)
    scales[:int(big * n)] *= 20.0
    s = gt.SplatData.from_numpy(means, scales, *rest, device=device)
    cam = gt.Camera.look_at((2.5, 1.5, 2.5), (0.0, 0.0, 0.0), fov_y_deg=60.0,
                            aspect=width / height, device=device)
    cfg = gt.RenderConfig(width=width, height=height, tile_size=tile,
                          record_precision="f32")
    with torch.no_grad():
        pairs = bin_sort_records(project_splats(s, cam, cfg), cfg)
    ids = torch.arange(cfg.num_tiles, dtype=torch.int32, device=device)
    return cfg, (pairs.records, pairs.tile_starts, pairs.tile_counts, ids)


def assert_cuda_b1_matches_plain(cfg, inputs):
    """B1 launched once on the card against the plain B1: chans and log T
    p99.9 |d| <= 1e-3 and <= 0.1% over 1e-2, exit_k equal on >= 99% of
    tiles; some pixel composited something."""
    before = metrics.total(cr.LAUNCHES)
    chans, logt, exit_k = cr.composite_fwd(*inputs, cfg)
    torch.cuda.synchronize()
    assert metrics.total(cr.LAUNCHES) == before + 1
    ref = cr.composite_fwd_torch(*inputs, cfg)
    for a, b in ((chans, ref[0]), (logt, ref[1])):
        p999, over = error_mass(a.cpu().numpy(), b.cpu().numpy())
        assert p999 <= 1e-3 and over <= 1e-3
    assert float((exit_k == ref[2]).float().mean()) >= 0.99
    assert float(ref[0][:, -1].max()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("big", [0.0, 0.05])
@pytest.mark.parametrize("tile", [12, 16, 20, 32, 36, 40, 64, 65, 80, 96,
                                  128, 256])
def test_cuda_b1_matches_plain_at_tile_sizes(cuda_device, tile, big):
    """B1 against its plain version at tiles 12, 16, 20 and 32 (warp
    patches cut at the tile's edge at 12 and 20), 36, 40 and 64 (a
    cluster of four 32 x 32 blocks; at 36 and 40 narrow quadrants with
    warps wholly past the tile's edge) and 65, 80, 96, 128 and 256 (one
    block walking 32 x 32 sub-tiles; at 65 and 80 narrow ones, at 256 one
    tile over the whole 200 x 150 image), on a scene and on the same scene
    with 5% of the splats scaled x20."""
    cfg, inputs = port_pairs(cuda_device, tile, seed=47, big=big)
    rx = inputs[0][9][:int(inputs[2].long().sum())]
    # boxes across 2 tiles or more (at 64: the scene's largest, ~125 px)
    assert float(rx.max()) > (min(2 * tile, 64) if big else 0.0)
    assert_cuda_b1_matches_plain(cfg, inputs)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [12, 16, 32, 64, 96, 128])
def test_cuda_b1_pairs_at_warp_edges(cuda_device, tile):
    """B1 against its plain version on hand-built records whose pairs sit
    just inside and just outside a warp's rectangle (edge_records), at 64
    across the quadrant seams and at 96 and 128 across the seams of the
    sub-tiles the block walks."""
    cfg = gt.RenderConfig(width=2 * tile, height=2 * tile, tile_size=tile)
    assert_cuda_b1_matches_plain(cfg, edge_records(cfg, 48 + tile,
                                                   cuda_device))


def assert_cuda_b2_matches_plain(cfg, inputs, device, seed):
    """B1, then B2 with a random cotangent, launched once on the card,
    against the plain B2: per row normalised p99.9 <= 1e-3 and <= 0.1%
    over 1e-2."""
    chans, logt, exit_k = cr.composite_fwd(*inputs, cfg)
    gch = 0.1 * torch.randn(chans.shape, device=device,
                            generator=torch.Generator(device).manual_seed(seed))
    before = metrics.total(cr.BWD_LAUNCHES)
    grad = cr.composite_bwd(*inputs, logt, exit_k, gch, cfg)
    torch.cuda.synchronize()
    assert metrics.total(cr.BWD_LAUNCHES) == before + 1
    ref = cr.composite_bwd_torch(*inputs, logt, exit_k, gch, cfg)
    for p999, over in norm_err(grad.cpu().numpy(), ref.cpu().numpy()):
        assert p999 <= 1e-3 and over <= 1e-3
    assert float(ref[:9].abs().amax(dim=1).min()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("big", [0.0, 0.05])
@pytest.mark.parametrize("tile", [12, 16, 20, 32, 36, 40, 64, 65, 80, 96,
                                  128, 256])
def test_cuda_b2_matches_plain_at_tile_sizes(cuda_device, tile, big):
    """B2 against its plain version at tiles 12, 16, 20 and 32 (tiles whose
    square is no multiple of 32 included), 36, 40 and 64 (a cluster of
    four blocks, whose sums meet in distributed shared memory) and 65, 80,
    96, 128 and 256 (one block replaying each 32 x 32 sub-tile in turn and
    adding its sums into the slots), on a scene and on the same scene with
    5% of the splats scaled x20, whose boxes span many warps and tiles."""
    cfg, inputs = port_pairs(cuda_device, tile, seed=42, big=big)
    rx = inputs[0][9][:int(inputs[2].long().sum())]
    # boxes across 2 tiles or more (at 64: the scene's largest, ~125 px)
    assert float(rx.max()) > (min(2 * tile, 64) if big else 0.0)
    assert_cuda_b2_matches_plain(cfg, inputs, cuda_device, seed=43)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [12, 16, 32, 64, 96, 128])
def test_cuda_b2_pairs_at_warp_edges(cuda_device, tile):
    """B2 against its plain version on hand-built records whose pairs sit
    just inside and just outside a warp's rectangle (edge_records), at 64
    across the quadrant seams and at 96 and 128 across the seams of the
    sub-tiles the block walks."""
    cfg = gt.RenderConfig(width=2 * tile, height=2 * tile, tile_size=tile)
    inputs = edge_records(cfg, 44 + tile, cuda_device)
    assert_cuda_b2_matches_plain(cfg, inputs, cuda_device, seed=45)


@pytest.mark.cuda
def test_cuda_b2_replays_where_t_dies(cuda_device):
    """B2 against its plain version where a chunk's sum of log(1 - alpha)
    falls below the floor (_exit_records' tile 0: the replay of B1's sum
    runs), before a window that starts in the exiting tile's last chunk."""
    cfg = gt.RenderConfig(width=32, height=32, tile_size=16)
    records, starts, counts = _exit_records()
    inputs = (torch.tensor(records, device=cuda_device),
              torch.tensor(starts, device=cuda_device),
              torch.tensor(counts, device=cuda_device),
              torch.arange(4, dtype=torch.int32, device=cuda_device))
    assert_cuda_b2_matches_plain(cfg, inputs, cuda_device, seed=46)


@pytest.mark.cuda
def test_cuda_b1_second_pass_at_tile_128(cuda_device):
    """B1 at tile 128 where one sub-tile outlives the others
    (walk_exit_records): the block runs the 10 sub-tiles before it a second
    time, to the tile's exit; exit_k is that sub-tile's own exit chunk, and
    every pixel matches the plain version."""
    cfg = gt.RenderConfig(width=WALK_TILE, height=WALK_TILE,
                          tile_size=WALK_TILE)
    inputs = walk_exit_records(cuda_device)
    k_sub, second = cr.walk_exits(cr.composite_fwd_torch, *inputs, cfg)
    assert second.tolist() == [WALK_SUB]
    _, _, exit_k = cr.composite_fwd(*inputs, cfg)
    assert exit_k.tolist() == [int(k_sub[0, WALK_SUB])] == [6]
    assert_cuda_b1_matches_plain(cfg, inputs)


@pytest.mark.cuda
def test_cuda_b2_replays_where_t_dies_at_tile_128(cuda_device):
    """B2 against its plain version at tile 128 on walk_exit_records:
    outside sub-tile (2, 2) chunk 0's sum falls below the floor, so the
    replay of B1's sum runs there, and that sub-tile's sums are added
    into the slots the first sub-tile wrote."""
    cfg = gt.RenderConfig(width=WALK_TILE, height=WALK_TILE,
                          tile_size=WALK_TILE)
    assert_cuda_b2_matches_plain(cfg, walk_exit_records(cuda_device),
                                 cuda_device, seed=47)


def test_build_names_libraries_by_source_and_needs_nvcc(monkeypatch):
    """The kernel build (run only when a CUDA path first launches):
    libraries are named by a hash of source and flags; without nvcc it
    raises instead of loading anything."""
    from gaussiansplats3d_tpu_torch import _build

    src, lib, report = _build._paths("composite_fwd")
    assert src.is_file() and lib.parent == _build.BUILD_DIR
    assert lib.name.startswith("libcomposite_fwd-") and lib.suffix == ".so"
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._paths("composite_fwd")[1] != lib
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_build_hashes_the_gauss_fragment_header(monkeypatch):
    """B1 and both passes of B2 evaluate alpha with one header,
    csrc/gauss_fragment.cuh (B2 replays B1's chunk sums bit for bit where
    T dies), and so does B5 on B1's layout: the sources include it, and
    the library names hash it, so an edited header renames the libraries
    and is rebuilt, never loaded stale; a library that does not include it
    keeps its name."""
    from gaussiansplats3d_tpu_torch import _build

    header = _build.CSRC / "gauss_fragment.cuh"
    names = {}
    for k in ("composite_fwd", "composite_bwd", "kernel_bench"):
        assert _build._local_headers(_build.CSRC / f"{k}.cu") == [
            header, _build.CSRC / "warp_cull.cuh"]
        names[k] = _build._paths(k)[1].name
    surfel = _build._paths("surfel_fwd")[1].name
    orig = _build.Path.read_bytes

    def edited(self):
        data = orig(self)
        return data + b"// edit" if self == header else data

    monkeypatch.setattr(_build.Path, "read_bytes", edited)
    assert all(_build._paths(k)[1].name != v for k, v in names.items())
    assert _build._paths("surfel_fwd")[1].name == surfel

