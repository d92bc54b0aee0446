"""Kernels B3 and B4 of the port (render/cuda_surfel.py): their plain
PyTorch versions against the JAX package's Pallas surfel kernels
(pallas_surfel._fwd and _bwd, run in interpret mode, as
tests/test_pallas_surfel.py runs them) on records the JAX package's
bin_sort_surfels produced (f32 precision, so the records are exact) and on
synthetic records; and, on a card, the CUDA kernels against their plain
versions and the 2D render on the card against the CPU.

Bars, by error mass (the hard culls flip on last-ulp differences, so never
the elementwise max).  B3: colors and log T p99.9 of |d| <= 1e-3, exit_k
equal on every tile.  B4, with a random gcol and a nonzero glogt: per
record row, |d| normalised by the row's max |reference|, p99.9 <= 1e-3;
the rx and ry rows exactly 0.  The Pallas kernels take their in-chunk
prefix sums on 2- and 3-limb bf16 matmuls; the plain versions in float64.
On the card: B3 p99.9 <= 1e-3 and <= 0.1% of elements over 1e-2, exit_k
equal on >= 99% of tiles; B4 normalised p99.9 <= 1e-3 and <= 0.1% over
1e-2; the 2D render's images and gradients as the 3D ones
(tests/test_torch_pipeline.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussiansplats3d_tpu as gs
import gaussiansplats3d_tpu_torch as gt
from gaussiansplats3d_tpu.render import pallas_surfel as ps
from gaussiansplats3d_tpu.render import surfel as surfel_j
from gaussiansplats3d_tpu_torch import _build
from gaussiansplats3d_tpu_torch.render import cuda_surfel as cs
from gaussiansplats3d_tpu_torch.utils import metrics

from torch_port_common import (WALK_SUB, WALK_TILE, both_cameras,  # noqa: F401
                               both_scenes, cuda_device, cull_case,
                               edge_pairs, edge_windows, error_mass,
                               interpret_pallas, scene_arrays,
                               walk_exit_boxes)

FIELDS = ("means", "scales", "quats", "colors", "sh")


# one compilation per configuration and shape
_bin_j = jax.jit(lambda s, cam, cfg: surfel_j.bin_sort_surfels(
    surfel_j.project_surfels(s, cam, cfg), cfg), static_argnums=(2,))


def jax_binned(depth=False, n=800, size=96, seed=31):
    """(cfg_j, cfg_t, JAX records [S, NC + 14], starts, counts) from the
    JAX package's projection and binning of a numpy-made scene."""
    s_j, _ = both_scenes(scene_arrays(n, sh_degree=0, seed=seed))
    cam = gs.Camera.look_at((2.5, 1.5, 2.5), (0, 0, 0), fov_y_deg=60,
                            aspect=1.0)
    kw = dict(width=size, height=size, record_precision="f32",
              return_depth=depth, render_mode_2d=True)
    cfg_j = gs.RenderConfig(**kw)
    recs, starts, counts, _, _ = _bin_j(s_j, cam, cfg_j)
    return cfg_j, gt.RenderConfig(**kw), recs, starts, counts


def port_inputs(recs, starts, counts, device="cpu"):
    """The records field-major, as the port bins them, and the windows."""
    t = np.asarray(starts).shape[0]
    return (torch.tensor(np.asarray(recs).T.copy(), device=device),
            torch.tensor(np.asarray(starts), device=device),
            torch.tensor(np.asarray(counts), device=device),
            torch.arange(t, dtype=torch.int32, device=device))


def pallas_fwd(cfg_j, recs, starts, counts):
    t = np.asarray(starts).shape[0]
    (col, logt), res = ps._fwd(cfg_j, recs.shape[0],
                               ps.pack_surfel_records(jnp.asarray(recs)),
                               jnp.asarray(starts), jnp.asarray(counts),
                               jnp.arange(t, dtype=jnp.int32))
    return np.asarray(col), np.asarray(logt), np.asarray(res[5]), res


def norm_err(a, b):
    """Per row of [R, S] gradients: (p99.9 of |a - b| / max |b|, share of
    elements with that ratio over 1e-2); rows where b is all 0 must be 0."""
    out = []
    for ra, rb in zip(np.asarray(a, np.float64), np.asarray(b, np.float64)):
        scale = np.abs(rb).max()
        if scale == 0.0:
            assert np.abs(ra).max() == 0.0
            out.append((0.0, 0.0))
            continue
        out.append(error_mass(ra / scale, rb / scale))
    return out


def _wall_records():
    """Synthetic surfels facing the camera: T = [[s, 0, 0], [0, s, 0],
    [cx, cy, 1]] maps tangent (u, v) to pixel (cx + s u, cy + s v) at depth
    1.  Tile 0 (16 px tiles of a 32x32 image): 300 wide near-opaque
    surfels at slots 0..299, which stop every pixel in chunk 0 (exit_k 1);
    tile 1: 50 small surfels in the window 300..349, which starts mid-chunk
    2, the chunk tile 0's window ends in; tiles 2 and 3: empty windows off
    a chunk boundary.  Returns (records [S, 17], starts, counts)."""
    rng = np.random.default_rng(61)
    rec = np.zeros((512, 17), np.float32)

    def surfels(sl, cx, cy, s, opa):
        m = sl.stop - sl.start
        rec[sl, 0] = s
        rec[sl, 4] = s
        rec[sl, 6], rec[sl, 7], rec[sl, 8] = cx, cy, 1.0
        rec[sl, 9], rec[sl, 10] = cx, cy
        rec[sl, 11:14] = rng.uniform(0.0, 1.0, (m, 3))
        rec[sl, 14] = opa
        rec[sl, 15] = rec[sl, 16] = np.ceil(np.asarray(s) * 3 * 16) / 16

    surfels(slice(0, 300), 8.0, 8.0, 40.0, 0.97)
    surfels(slice(300, 350), rng.uniform(16.0, 32.0, 50),
            rng.uniform(0.0, 16.0, 50), rng.uniform(1.0, 3.0, 50),
            rng.uniform(0.3, 0.9, 50))
    return rec, np.array([0, 300, 350, 350], np.int32), \
        np.array([300, 50, 0, 0], np.int32)


def _wall_cfgs():
    kw = dict(width=32, height=32, tile_size=16, render_mode_2d=True)
    return gs.RenderConfig(**kw), gt.RenderConfig(**kw)


def test_surfel_alpha_matches_pallas_fragment():
    """The plain fragment (the CUDA header's arithmetic) against the Pallas
    kernel's _surfel_chunk_alpha on the records of a scene, every pixel of
    a tile."""
    cfg_j, _, recs, starts, counts = jax_binned()
    rec = np.asarray(recs).T                                  # [17, S]
    tile = int(np.argmax(np.asarray(counts)))
    lo = int(np.asarray(starts)[tile]) // 128 * 128
    chunk = rec[:, lo:lo + 128]
    px, py = ps._pixel_coords(jnp.int32(tile), cfg_j)
    window = jnp.ones((1, 128), bool)
    alpha_j = np.asarray(ps._surfel_chunk_alpha(
        jnp.asarray(chunk), px, py, window, cfg_j.min_alpha)[0])  # [P, C]
    c = torch.tensor(chunk)[:, None, :]
    alpha_t = cs.surfel_alpha(c[:9], c[9], c[10], c[14], c[15], c[16],
                              torch.tensor(np.asarray(px)),
                              torch.tensor(np.asarray(py)),
                              cfg_j.min_alpha).numpy()
    assert (alpha_j > 0).sum() > 200
    p999, over = error_mass(alpha_t, alpha_j, bar=1e-3)
    assert p999 <= 1e-5 and over <= 1e-3


@pytest.mark.parametrize("case", ["scene", "depth", "wall"])
def test_plain_b3_matches_interpret_pallas(interpret_pallas, case):
    """Colors, log T and exit_k against the Pallas kernel: a scene of
    several chunks a tile (NC 3), the same with the depth channel (NC 4),
    and the synthetic wall (an early exit, a window not aligned to 128 that
    starts in the exiting tile's last chunk, empty windows)."""
    if case == "wall":
        cfg_j, cfg_t = _wall_cfgs()
        recs, starts, counts = _wall_records()
    else:
        cfg_j, cfg_t, recs, starts, counts = jax_binned(depth=case == "depth")
    col_p, logt_p, exit_p, _ = pallas_fwd(cfg_j, recs, starts, counts)
    col, logt, exit_k = (x.numpy() for x in cs.composite_surfel_fwd(
        *port_inputs(recs, starts, counts), cfg_t))
    assert col.shape == col_p.shape == (cfg_t.num_tiles,
                                        cfg_t.tile_size ** 2,
                                        4 if case == "depth" else 3)
    np.testing.assert_array_equal(exit_k, exit_p)
    for a, b in ((col, col_p), (logt, logt_p)):
        assert error_mass(a, b)[0] <= 1e-3
    if case == "wall":
        assert exit_k.tolist() == [1, 1, 1, 1]
        assert float(logt[0].max()) < -9.2          # every pixel stopped
        assert float(np.exp(logt[1]).min()) < 0.5   # tile 1's surfels hit
        assert np.abs(col[2:]).max() == 0.0
    else:
        assert exit_k.max() >= 2                    # several chunks


@pytest.mark.parametrize("case", ["scene", "depth", "wall"])
def test_plain_b4_matches_interpret_pallas(interpret_pallas, case):
    """The plain B4, replaying the plain B3's residuals, against the Pallas
    _bwd on the Pallas forward's, with a random gcol and a nonzero glogt."""
    if case == "wall":
        cfg_j, cfg_t = _wall_cfgs()
        recs, starts, counts = _wall_records()
    else:
        cfg_j, cfg_t, recs, starts, counts = jax_binned(
            depth=case == "depth", seed=62)
    inputs = port_inputs(recs, starts, counts)
    col, logt, exit_k = cs.composite_surfel_fwd_torch(*inputs, cfg_t)
    rng = np.random.default_rng(63)
    gcol = rng.normal(0.0, 0.1, tuple(col.shape)).astype(np.float32)
    glogt = rng.normal(0.0, 0.1, tuple(logt.shape)).astype(np.float32)
    grad = cs.composite_surfel_bwd_torch(
        *inputs, logt, exit_k, torch.tensor(gcol), torch.tensor(glogt),
        cfg_t).numpy()
    _, _, _, res = pallas_fwd(cfg_j, recs, starts, counts)
    ref = np.asarray(ps._bwd(cfg_j, recs.shape[0], res,
                             (jnp.asarray(gcol), jnp.asarray(glogt)))[0])
    nf = grad.shape[0]
    ref = ref[:nf]
    assert np.abs(grad[nf - 2:]).max() == 0.0      # rx, ry: no gradient
    for row, (p999, _) in enumerate(norm_err(grad[:nf - 2], ref[:nf - 2])):
        assert p999 <= 1e-3, (case, row, p999)
    end = int(np.asarray(starts)[-1] + np.asarray(counts)[-1])
    assert np.abs(grad[:, end:]).max() == 0.0      # outside every window
    if case == "wall":
        assert np.abs(grad[:, 128:300]).max() == 0.0   # past tile 0's exit
        assert np.abs(grad[:nf - 2, 300:350]).min(axis=1).max() > 0.0
    # the glogt term is B4's own: without it the opacity row changes
    no_glogt = cs.composite_surfel_bwd_torch(
        *inputs, logt, exit_k, torch.tensor(gcol),
        torch.zeros_like(logt), cfg_t).numpy()
    assert np.abs(no_glogt[nf - 3] - grad[nf - 3]).max() > 1e-3 * np.abs(
        grad[nf - 3]).max()


def test_wrapper_cpu_path_autograd_and_checks():
    """The autograd boundary passes both cotangents to the plain B4 on the
    CPU and launches no kernel; the wrappers check their inputs."""
    _, cfg = _wall_cfgs()
    recs, starts, counts = _wall_records()
    rec = torch.tensor(recs.T.copy(), requires_grad=True)
    starts, counts = torch.tensor(starts), torch.tensor(counts)
    ids = torch.arange(4, dtype=torch.int32)
    before = (metrics.total(cs.LAUNCHES), metrics.total(cs.BWD_LAUNCHES))
    col, logt, exit_k = cs.composite_surfel_tiles(cfg, rec, starts, counts,
                                                  ids)
    gen = torch.Generator().manual_seed(64)
    gcol = torch.randn(col.shape, generator=gen)
    glogt = torch.randn(logt.shape, generator=gen)
    ((col * gcol).sum() + (logt * glogt).sum()).backward()
    assert (metrics.total(cs.LAUNCHES),
            metrics.total(cs.BWD_LAUNCHES)) == before
    np.testing.assert_array_equal(rec.grad.numpy(), cs.composite_surfel_bwd(
        rec.detach(), starts, counts, ids, logt.detach(), exit_k, gcol,
        glogt, cfg).numpy())
    r = rec.detach()
    bad = [
        lambda: cs.composite_surfel_fwd(r[:16], starts, counts, ids, cfg),
        lambda: cs.composite_surfel_fwd(r[:, :100], starts, counts, ids,
                                        cfg),
        lambda: cs.composite_surfel_fwd(r, starts.long(), counts, ids, cfg),
        lambda: cs.composite_surfel_fwd_cuda(r, starts, counts, ids, cfg),
        lambda: cs.composite_surfel_bwd(r, starts, counts, ids,
                                        logt.detach(), exit_k,
                                        gcol[..., :2].contiguous(), glogt,
                                        cfg),
        lambda: cs.composite_surfel_bwd_cuda(r, starts, counts, ids,
                                             logt.detach(), exit_k, gcol,
                                             glogt, cfg),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()


def test_build_hashes_the_fragment_header():
    """B3 and B4 share csrc/surfel_fragment.cuh (and warp_cull.cuh): the
    library names hash it, so an edited header is rebuilt, never loaded
    stale."""
    assert {"surfel_fwd", "surfel_bwd"} <= set(_build.KERNELS)
    header = _build.CSRC / "surfel_fragment.cuh"
    cull = _build.CSRC / "warp_cull.cuh"
    names = {}
    for k, headers in (("surfel_fwd", [header, cull]),
                       ("surfel_bwd", [header, cull])):
        assert _build._local_headers(_build.CSRC / f"{k}.cu") == headers
        names[k] = _build._paths(k)[1].name
    orig = _build.Path.read_bytes

    def edited(self):
        data = orig(self)
        return data + b"// edit" if self == header else data

    _build.Path.read_bytes = edited
    try:
        assert all(_build._paths(k)[1].name != v for k, v in names.items())
        assert _build._paths("composite_fwd")[1].name.startswith(
            "libcomposite_fwd-")
    finally:
        _build.Path.read_bytes = orig


@pytest.mark.parametrize("tile", [12, 16, 20, 32, 40, 64, 96, 128])
def test_warp_cull_mirror_keeps_every_box_hit(tile):
    """The plain mirror of B3's and B4's per-warp cull (warp_keep over
    their warp rectangles) keeps every pair that passes the per-pixel box
    test at some pixel of the warp, on pairs whose centres or box edges sit
    within 1e-3 px of a warp rectangle's edge, half of them with boxes
    under a pixel, also where a tile's edge cuts the warps' patches, (at
    40 and 64) on boxes across the quadrant seams and (at 96 and 128)
    across the seams of the sub-tiles a block walks; and it drops some."""
    cfg = gt.RenderConfig(width=2 * tile, height=2 * tile, tile_size=tile,
                          render_mode_2d=True)
    hit, keep = cull_case(cfg, seed=70 + tile)
    assert bool(hit.any()) and bool((~keep).any())
    assert int((hit & ~keep).sum()) == 0


def port_surfels(device, tile, seed, big=0.0, n=3000, size=192):
    """The port's own f32 surfel records of a numpy-made scene, binned on
    ``device`` at tile size ``tile``, the first ``big`` share of the splats
    scaled x20: (cfg, (records, starts, counts, tile ids))."""
    from gaussiansplats3d_tpu_torch.render.surfel import (bin_sort_surfels,
                                                          project_surfels)
    means, scales, *rest = scene_arrays(n, sh_degree=0, seed=seed)
    scales[:int(big * n)] *= 20.0
    s = gt.SplatData.from_numpy(means, scales, *rest, device=device)
    cam = gt.Camera.look_at((2.5, 1.5, 2.5), (0.0, 0.0, 0.0), fov_y_deg=60.0,
                            aspect=1.0, device=device)
    cfg = gt.RenderConfig(width=size, height=size, tile_size=tile,
                          record_precision="f32", render_mode_2d=True)
    with torch.no_grad():
        recs, starts, counts, _, _ = bin_sort_surfels(
            project_surfels(s, cam, cfg), cfg)
    ids = torch.arange(cfg.num_tiles, dtype=torch.int32, device=device)
    return cfg, (recs, starts, counts, ids)


def edge_surfels(cfg, seed, device):
    """Surfels built by hand over 2 x 2 tiles (edge_pairs at B4's warp
    rectangles), in windows that start mid-chunk, facing the camera as in
    _wall_records: T = [[rx / 2, 0, 0], [0, ry / 2, 0], [cx, cy, 1]], the
    box at two tangent units; random colours and opacities 0.3-0.9."""
    x, y, rx, ry, tile = edge_pairs(cfg, seed, n=1200)
    slot, starts, counts, cap = edge_windows(tile, cfg.num_tiles)
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    rec = np.zeros((17, cap), np.float32)
    zero, one = np.zeros(n, np.float32), np.ones(n, np.float32)
    rec[:, slot] = np.stack([
        rx / 2, zero, zero, zero, ry / 2, zero, x, y, one, x, y,
        *rng.uniform(0.0, 1.0, (3, n)), rng.uniform(0.3, 0.9, n), rx, ry])
    return (torch.tensor(rec, device=device),
            torch.tensor(starts, device=device),
            torch.tensor(counts, device=device),
            torch.arange(cfg.num_tiles, dtype=torch.int32, device=device))


def walk_exit_surfels(device):
    """walk_exit_boxes as B3's records [17, 896], facing the camera as in
    _wall_records with s = 1e4 tangent units a pixel: rho ~ 0, so alpha is
    the opacity wherever the box holds the pixel centre; with its window
    and tile id 0 on ``device``."""
    (cx, cy, rx, ry, opa, rgb), (starts, counts) = walk_exit_boxes()
    rec = np.zeros((17, 896), np.float32)
    zero, one = np.zeros_like(cx), np.ones_like(cx)
    rec[:, :800] = np.stack([1e4 * one, zero, zero, zero, 1e4 * one, zero,
                             cx, cy, one, cx, cy, *rgb, opa, rx, ry])
    return (torch.tensor(rec, device=device),
            torch.tensor(starts, device=device),
            torch.tensor(counts, device=device),
            torch.zeros(1, dtype=torch.int32, device=device))


def _walk_cfg():
    return gt.RenderConfig(width=WALK_TILE, height=WALK_TILE,
                           tile_size=WALK_TILE, render_mode_2d=True)


def test_walk_exits_of_the_second_pass_surfels():
    """The walk's second-pass case as surfels (walk_exit_surfels), on the
    plain B3: the tile exits after chunk 6 of 7, the exit of sub-tile (2,
    2) alone; every other sub-tile's own exit is chunk 1, so the walk runs
    the 10 sub-tiles before it a second time (walk_exits)."""
    from gaussiansplats3d_tpu_torch.render import cuda_rasterize as cr
    inputs = walk_exit_surfels("cpu")
    _, logt, exit_k = cs.composite_surfel_fwd(*inputs, _walk_cfg())
    k_sub, second = cr.walk_exits(cs.composite_surfel_fwd_torch, *inputs,
                                  _walk_cfg())
    assert exit_k.tolist() == [6]
    assert k_sub[0, WALK_SUB] == 6 and second.tolist() == [WALK_SUB]
    assert set(k_sub[0].tolist()) == {1, 6}
    assert float(logt.min()) < cr.CS_FLOOR


def assert_cuda_b3_matches_plain(cfg, inputs):
    """B3 launched once on the card against the plain B3: colors and log T
    p99.9 |d| <= 1e-3 and <= 0.1% over 1e-2, exit_k equal on >= 99% of
    tiles; some pixel composited something."""
    before = metrics.total(cs.LAUNCHES)
    col, logt, exit_k = cs.composite_surfel_fwd(*inputs, cfg)
    torch.cuda.synchronize()
    assert metrics.total(cs.LAUNCHES) == before + 1
    ref = cs.composite_surfel_fwd_torch(*inputs, cfg)
    for a, b in ((col, ref[0]), (logt, ref[1])):
        p999, over = error_mass(a.cpu().numpy(), b.cpu().numpy())
        assert p999 <= 1e-3 and over <= 1e-3
    assert float((exit_k == ref[2]).float().mean()) >= 0.99
    assert float(ref[1].min()) < 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("big", [0.0, 0.05])
@pytest.mark.parametrize("tile", [12, 16, 20, 32, 36, 40, 64, 65, 80, 96,
                                  128, 256])
def test_cuda_b3_matches_plain_at_tile_sizes(cuda_device, tile, big):
    """B3 against its plain version at tiles 12, 16, 20 and 32 (warp
    patches cut at the tile's edge at 12 and 20), 36, 40 and 64 (a
    cluster of four 32 x 32 blocks; narrow quadrants at 36 and 40) and 65,
    80, 96, 128 and 256 (one block walking 32 x 32 sub-tiles; narrow ones
    at 65 and 80), on a scene and on the same scene with 5% of the splats
    scaled x20."""
    cfg, inputs = port_surfels(cuda_device, tile, seed=76, big=big)
    rx = inputs[0][15][:int(inputs[2].long().sum())]
    # boxes across 2 tiles or more (at 64: the scene's largest, ~125 px)
    assert float(rx.max()) > (min(2 * tile, 64) if big else 0.0)
    assert_cuda_b3_matches_plain(cfg, inputs)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [12, 16, 32, 64, 96, 128])
def test_cuda_b3_pairs_at_warp_edges(cuda_device, tile):
    """B3 against its plain version on hand-built surfels that sit just
    inside and just outside a warp's rectangle (edge_surfels), at 64
    across the quadrant seams and at 96 and 128 across the seams of the
    sub-tiles the block walks."""
    cfg = gt.RenderConfig(width=2 * tile, height=2 * tile, tile_size=tile,
                          render_mode_2d=True)
    assert_cuda_b3_matches_plain(cfg, edge_surfels(cfg, 77 + tile,
                                                   cuda_device))


def assert_cuda_b4_matches_plain(cfg, inputs, device, seed):
    """B3, then B4 with a random gcol and glogt, launched once on the
    card, against the plain B4: per row normalised p99.9 <= 1e-3 and <=
    0.1% over 1e-2."""
    col, logt, exit_k = cs.composite_surfel_fwd(*inputs, cfg)
    gen = torch.Generator(device).manual_seed(seed)
    gcol = 0.1 * torch.randn(col.shape, device=device, generator=gen)
    glogt = 0.1 * torch.randn(logt.shape, device=device, generator=gen)
    before = metrics.total(cs.BWD_LAUNCHES)
    grad = cs.composite_surfel_bwd(*inputs, logt, exit_k, gcol, glogt, cfg)
    torch.cuda.synchronize()
    assert metrics.total(cs.BWD_LAUNCHES) == before + 1
    ref = cs.composite_surfel_bwd_torch(*inputs, logt, exit_k, gcol, glogt,
                                        cfg)
    for p999, over in norm_err(grad.cpu().numpy(), ref.cpu().numpy()):
        assert p999 <= 1e-3 and over <= 1e-3
    # the channel and opacity rows always have a gradient (the center's
    # only where the screen-space term wins somewhere)
    assert float(ref[11:-2].abs().amax(dim=1).min()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("big", [0.0, 0.05])
@pytest.mark.parametrize("tile", [12, 16, 20, 32, 36, 40, 64, 65, 80, 96,
                                  128, 256])
def test_cuda_b4_matches_plain_at_tile_sizes(cuda_device, tile, big):
    """B4 against its plain version at tiles 12, 16, 20 and 32, 36, 40 and
    64 (a cluster of four blocks, whose sums meet in distributed shared
    memory) and 65, 80, 96, 128 and 256 (one block replaying each 32 x 32
    sub-tile in turn and adding its sums into the slots), on a scene and
    on the same scene with 5% of the splats scaled x20, whose boxes span
    many warps and tiles."""
    cfg, inputs = port_surfels(cuda_device, tile, seed=71, big=big)
    rx = inputs[0][15][:int(inputs[2].long().sum())]
    # boxes across 2 tiles or more (at 64: the scene's largest, ~125 px)
    assert float(rx.max()) > (min(2 * tile, 64) if big else 0.0)
    assert_cuda_b4_matches_plain(cfg, inputs, cuda_device, seed=72)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [12, 16, 32, 64, 96, 128])
def test_cuda_b4_pairs_at_warp_edges(cuda_device, tile):
    """B4 against its plain version on hand-built surfels that sit just
    inside and just outside a warp's rectangle (edge_surfels), at 64
    across the quadrant seams and at 96 and 128 across the seams of the
    sub-tiles the block walks."""
    cfg = gt.RenderConfig(width=2 * tile, height=2 * tile, tile_size=tile,
                          render_mode_2d=True)
    inputs = edge_surfels(cfg, 73 + tile, cuda_device)
    assert_cuda_b4_matches_plain(cfg, inputs, cuda_device, seed=74)


@pytest.mark.cuda
def test_cuda_b4_replays_where_t_dies(cuda_device):
    """B4 against its plain version on the wall (_wall_records: tile 0's
    first chunk drives T below the floor, so the replay of B3's sum runs),
    with an unaligned window in the exiting tile's last chunk."""
    _, cfg = _wall_cfgs()
    inputs = port_inputs(*_wall_records(), device=cuda_device)
    assert_cuda_b4_matches_plain(cfg, inputs, cuda_device, seed=75)


@pytest.mark.cuda
def test_cuda_b3_second_pass_at_tile_128(cuda_device):
    """B3 at tile 128 where one sub-tile outlives the others
    (walk_exit_surfels): the block runs the 10 sub-tiles before it a second
    time; exit_k is that sub-tile's own exit chunk, every pixel matches the
    plain version, and B4 replays the dying chunk against its plain
    version."""
    from gaussiansplats3d_tpu_torch.render import cuda_rasterize as cr
    inputs = walk_exit_surfels(cuda_device)
    k_sub, second = cr.walk_exits(cs.composite_surfel_fwd_torch, *inputs,
                                  _walk_cfg())
    assert second.tolist() == [WALK_SUB]
    _, _, exit_k = cs.composite_surfel_fwd(*inputs, _walk_cfg())
    assert exit_k.tolist() == [int(k_sub[0, WALK_SUB])] == [6]
    assert_cuda_b3_matches_plain(_walk_cfg(), inputs)
    assert_cuda_b4_matches_plain(_walk_cfg(), inputs, cuda_device, seed=76)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [False, True])
def test_cuda_b3_b4_match_plain(cuda_device, depth):
    """B3, then B4 with a random gcol and glogt, on the card against their
    plain versions, each launched once."""
    _, cfg_t, recs, starts, counts = jax_binned(depth=depth, n=3000,
                                                size=192, seed=65)
    inputs = port_inputs(recs, starts, counts, device=cuda_device)
    before = (metrics.total(cs.LAUNCHES), metrics.total(cs.BWD_LAUNCHES))
    col, logt, exit_k = cs.composite_surfel_fwd(*inputs, cfg_t)
    gen = torch.Generator(cuda_device).manual_seed(66)
    gcol = 0.1 * torch.randn(col.shape, device=cuda_device, generator=gen)
    glogt = 0.1 * torch.randn(logt.shape, device=cuda_device, generator=gen)
    grad = cs.composite_surfel_bwd(*inputs, logt, exit_k, gcol, glogt,
                                   cfg_t)
    torch.cuda.synchronize()
    assert (metrics.total(cs.LAUNCHES),
            metrics.total(cs.BWD_LAUNCHES)) == (before[0] + 1, before[1] + 1)
    ref = cs.composite_surfel_fwd_torch(*inputs, cfg_t)
    for a, b in ((col, ref[0]), (logt, ref[1])):
        p999, over = error_mass(a.cpu().numpy(), b.cpu().numpy())
        assert p999 <= 1e-3 and over <= 1e-3
    assert float((exit_k == ref[2]).float().mean()) >= 0.99
    ref_g = cs.composite_surfel_bwd_torch(*inputs, logt, exit_k, gcol, glogt,
                                          cfg_t)
    for p999, over in norm_err(grad.cpu().numpy(), ref_g.cpu().numpy()):
        assert p999 <= 1e-3 and over <= 1e-3


@pytest.mark.cuda
def test_cuda_render_2d_matches_cpu(cuda_device):
    """render() in 2D on the card launches B3 once forward and B4 once
    backward, and gives the CPU render's images and gradients."""
    arrays = scene_arrays(3000, sh_degree=1, seed=67)
    cam_j, _ = both_cameras(gs.Camera.look_at((2.5, 1.5, 2.5), (0, 0, 0),
                                              fov_y_deg=60, aspect=4 / 3))
    cfg = gt.RenderConfig(width=256, height=192, sh_degree=1,
                          record_precision="f32", return_depth=True,
                          render_mode_2d=True, background=(0.2, 0.3, 0.4))
    outs, grads = [], []
    for dev in ("cpu", cuda_device):
        s = gt.SplatData.from_numpy(*arrays, device=dev)
        for f in FIELDS:
            getattr(s, f).requires_grad_(True)
        _, cam = both_cameras(cam_j, device=dev)
        before = (metrics.total(cs.LAUNCHES), metrics.total(cs.BWD_LAUNCHES))
        out = gt.render(s, cam, cfg)
        ((out["color"] ** 2).mean() + (out["depth"] ** 2).mean()).backward()
        expect = 1 if dev != "cpu" else 0
        assert (metrics.total(cs.LAUNCHES),
                metrics.total(cs.BWD_LAUNCHES)) == (before[0] + expect,
                                                    before[1] + expect)
        outs.append({k: v.detach().cpu().numpy() for k, v in out.items()})
        grads.append({f: getattr(s, f).grad.cpu().numpy() for f in FIELDS})
    for k in ("color", "alpha", "depth"):
        p999, over = error_mass(outs[1][k], outs[0][k])
        assert p999 <= 1e-3 and over <= 1e-3, k
    for f in FIELDS:
        scale = np.abs(grads[0][f]).max()
        p999, over = error_mass(grads[1][f] / scale, grads[0][f] / scale)
        assert p999 <= 1e-3 and over <= 1e-3, (f, p999, over)
