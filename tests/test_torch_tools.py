"""The port's tools slice (gaussiansplats3d_tpu_torch/tools, utils, viewer
enums): kernel B5's plain versions against the JAX package's Pallas
build_variant (interpret mode) on records the JAX package's
bin_sort_records produced (f32 precision, rows 0-10 for the port); each
tool's entry point on the CPU at a tiny size, create_ksplat's bytes and
render_scene's frames against the JAX tools'; and, on a card, B5 and the
parity gate.

Bars.  B5 plain vs Pallas: colors and T, each normalised by the Pallas
output's max, p99.9 of |d| <= 1e-5 and exit_k equal on every tile; the
port's log_scan against the JAX mxu_scan_3 (its log-space prefix through 3
bf16 limbs) at p99.9 <= 1e-4.  On the card: every
B5 variant against its plain version, normalised p99.9 <= 1e-3 and <= 0.1%
of elements over 1e-2, exit_k equal on >= 99% of tiles.  create_ksplat:
byte for byte.  render_scene: the 8-bit frames by error mass, p99.9 of
|d| <= 1e-3 and <= 0.1% of values over 1e-2."""

import contextlib
import dataclasses
import io
import json
import logging
import math
import os

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
from gaussiansplats3d_tpu.tools import kernel_bench as kb_j
from gaussiansplats3d_tpu_torch.tools import (bench_configs, gpu_parity,
                                              kernel_bench as kb,
                                              profile_stages, train_scene)
from gaussiansplats3d_tpu_torch.utils import metrics
from gaussiansplats3d_tpu_torch.utils import logging as glog
from gaussiansplats3d_tpu_torch.viewer.enums import LogLevel

from torch_port_common import (cuda_device, edge_records,  # noqa: F401
                               error_mass, interpret_pallas, scene_arrays)

# JAX variant -> the port's
JAX_VARIANTS = {"full": "full", "mxu_scan_2": "log_scan",
                "mxu_scan_3": "log_scan", "exit_every4": "exit_every4",
                "no_exit": "no_exit", "no_scan": "no_scan",
                "no_matmul": "no_matmul", "dma_only": "dma_only",
                "grid_only": "grid_only"}


def wall_scene(n=500, n_wall=400, seed=3):
    """Random splats behind an opaque wall of 400 near-opaque, flat splats
    over the right half of the view: the right tiles exit before their last
    chunk, the left ones walk every chunk."""
    means, scales, quats, colors, sh = scene_arrays(n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    wm = np.stack([rng.uniform(0.0, 1.4, n_wall),
                   rng.uniform(-1.4, 1.4, n_wall),
                   np.full(n_wall, 1.2)], 1)
    ws = rng.uniform(0.15, 0.3, (n_wall, 3))
    ws[:, 2] = 0.01
    wq = np.tile([0.0, 0.0, 0.0, 1.0], (n_wall, 1))
    wc = np.concatenate([rng.uniform(0.0, 1.0, (n_wall, 3)),
                         np.full((n_wall, 1), 0.98)], 1)

    def cat(a, b):
        return np.concatenate([a, b]).astype(np.float32)

    return (cat(means, wm), cat(scales, ws), cat(quats, wq),
            cat(colors, wc), np.zeros((n + n_wall, 0, 3), np.float32))


_cache = {}


def wall_records(size=64, tile=32):
    """(cfg_j, cfg_t, JAX [16, S] records, starts, counts): the wall scene
    at size x size (by default 64x64, 4 tiles of 32), binned once by the
    JAX package in f32."""
    if (size, tile) not in _cache:
        s_j = gs.SplatData(*(jnp.asarray(a) for a in wall_scene()))
        cam = gs.Camera.look_at((0.0, 0.0, 3.5), (0, 0, 0), fov_y_deg=60,
                                aspect=1.0)
        kw = dict(width=size, height=size, tile_size=tile,
                  record_precision="f32")
        cfg_j = gs.RenderConfig(**kw)
        q = jax.jit(lambda s: bin_j.bin_sort_records(
            proj_j.project_splats(s, cam, cfg_j), cfg_j))(s_j)
        rec16 = pr.pack_records_flat(q.xs, q.ys, q.cas, q.cbs, q.ccs, q.crs,
                                     q.cgs, q.cbs2, q.opas, q.rxs, q.rys)
        _cache[size, tile] = (cfg_j, gt.RenderConfig(**kw), rec16,
                              q.tile_starts, q.tile_counts)
    return _cache[size, tile]


def port_inputs(rec16, starts, counts, device="cpu"):
    t = np.asarray(starts).shape[0]
    return (torch.tensor(np.asarray(rec16)[:11], device=device),
            torch.tensor(np.asarray(starts), device=device),
            torch.tensor(np.asarray(counts), device=device),
            torch.arange(t, dtype=torch.int32, device=device))


def norm_p999(a, b):
    """p99.9 of |a - b| / max |b| (b all 0: of |a - b|)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max() or 1.0
    return error_mass(a / scale, b / scale)[0]


@pytest.mark.parametrize("jax_variant", list(JAX_VARIANTS))
def test_b5_plain_matches_jax_build_variant(interpret_pallas, jax_variant):
    _assert_b5_plain_matches_jax(wall_records(), jax_variant)


@pytest.mark.parametrize("jax_variant", list(JAX_VARIANTS))
def test_b5_plain_matches_jax_build_variant_at_tile_64(interpret_pallas,
                                                       jax_variant):
    """The same at tile 64 (the wall scene at 128 x 128, 2 x 2 tiles; on a
    card B5 runs each tile as a cluster of four 32 x 32 blocks)."""
    _assert_b5_plain_matches_jax(wall_records(size=128, tile=64),
                                 jax_variant)


def _assert_b5_plain_matches_jax(records, jax_variant):
    cfg_j, cfg_t, rec16, starts, counts = records
    t = cfg_j.num_tiles
    p = cfg_j.tile_size ** 2
    cj, tj, ej = (np.asarray(x) for x in kb_j.build_variant(
        cfg_j, jax_variant)(rec16, starts, counts,
                            jnp.arange(t, dtype=jnp.int32)))
    variant = JAX_VARIANTS[jax_variant]
    ct, tt, et = (x.numpy() for x in kb.build_variant(cfg_t, variant)(
        *port_inputs(rec16, starts, counts)))
    assert ct.shape == cj.shape == (t, p, 3)
    assert tt.shape == tj.shape == (t, p, 1)
    np.testing.assert_array_equal(et, ej)
    bar = 1e-4 if jax_variant == "mxu_scan_3" else 1e-5
    assert norm_p999(ct, cj) <= bar
    assert norm_p999(tt, tj) <= bar


def test_b5_wall_scene_exits_early_and_windows_are_unaligned():
    """What the comparison above covers: windows off the 128 grid, tiles
    that exit before their last chunk (full) and walk every chunk
    (no_exit), exit_every4 stopping on multiples of 4."""
    _, cfg_t, rec16, starts, counts = wall_records()
    args = port_inputs(rec16, starts, counts)
    assert (np.asarray(starts)[1:] % 128 != 0).all()
    num_chunks = (args[1] % 128 + args[2] + 127) // 128
    ek = {v: kb.composite_variant_torch(*args, cfg_t, v)[2]
          for v in ("full", "no_exit", "exit_every4", "grid_only")}
    assert torch.equal(ek["no_exit"], num_chunks.int())
    assert torch.equal(ek["grid_only"], num_chunks.int())
    assert bool((ek["full"] < num_chunks).any())
    assert bool((ek["full"] == num_chunks).any())
    early = ek["exit_every4"] < num_chunks
    assert bool((ek["exit_every4"][early] % 4 == 0).all())


def test_b5_wrapper_checks_and_counts():
    _, cfg_t, rec16, starts, counts = wall_records()
    args = port_inputs(rec16, starts, counts)
    with pytest.raises(ValueError, match="unknown variant"):
        kb.build_variant(cfg_t, "mxu_scan_2")
    rec12 = torch.cat([args[0], torch.zeros_like(args[0][:1])])
    with pytest.raises(ValueError, match="NC = 3"):
        kb.build_variant(cfg_t, "full")(rec12, *args[1:])
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kb.variant_cuda(*args, cfg_t, "full")
    kb.reset_launches()
    kb.build_variant(cfg_t, "full")(*args)      # the plain version
    assert metrics.total(kb.LAUNCHES) == 0


def test_kernel_bench_main_prints_every_variant(monkeypatch):
    # one call per timing (the tool's five are a matter of the card)
    monkeypatch.setattr(kb, "timeit", lambda fn, device, iters=5:
                        (fn(), 0.0)[1])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert kb.main(["40", "--cpu"]) == 0
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("N=40 tile=32 pairs=")
    for v in kb.VARIANTS:
        assert sum(line.split()[0] == v for line in lines) == 1
        assert "mean exit_k" in next(x for x in lines if x.split()[0] == v)
    assert any("REAL fwd" in x for x in lines)
    assert any("REAL bwd" in x for x in lines)


def test_profile_stages_prints_every_stage():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert profile_stages.main(["300", "--cpu", "--width", "64",
                                    "--height", "64"]) == 0
    text = out.getvalue()
    for stage in ("project fwd", "bin_sort_records fwd", "composite fwd",
                  "assemble", "FWD total", "composite bwd",
                  "bwd gather_bwd", "bin_sort bwd", "project bwd",
                  "FWD+BWD total", "Msplats/s fwd+bwd"):
        assert stage in text, stage
    for key in ("FWD total", "FWD+BWD total"):
        line = next(x for x in text.splitlines() if key + " " in x)
        assert math.isfinite(float(line.split()[len(key.split())]))


@pytest.mark.parametrize("tool", ["kernel_bench", "profile_stages"])
def test_tools_take_tile_64(monkeypatch, tool):
    """kernel_bench and profile_stages at --tile 64 on the CPU: the side
    reaches RenderConfig (the tools check nothing of their own)."""
    monkeypatch.setattr(kb, "timeit", lambda fn, device, iters=5:
                        (fn(), 0.0)[1])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if tool == "kernel_bench":
            assert kb.main(["40", "--cpu", "--tile", "64"]) == 0
        else:
            assert profile_stages.main(["300", "--cpu", "--width", "128",
                                        "--height", "96", "--tile",
                                        "64"]) == 0
    text = out.getvalue()
    assert ("N=40 tile=64 pairs=" in text if tool == "kernel_bench"
            else "tile=64" in text)


def test_gpu_parity_without_a_card_returns_2(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert gpu_parity.main() == 2
    assert "no CUDA device" in out.getvalue()


def test_gpu_parity_scene_and_mass_gate():
    s = gpu_parity.build_scene("cpu")
    assert s.num_splats == 6000 and s.sh_degree == 1
    ref = gt.random_splats(torch.Generator().manual_seed(11), 6000,
                           sh_degree=1, device="cpu")
    big = (s.scales != ref.scales).all(dim=1)
    assert 0.01 < float(big.float().mean()) < 0.03
    torch.testing.assert_close(s.scales[big], ref.scales[big] * 20.0)
    assert bool((s.colors[:, 3] <= torch.tensor(0.98)).all())
    rng = np.random.default_rng(0)
    small = np.abs(rng.normal(0.0, 1e-6, 100_000))
    for err, ok in ((small, True),
                    (np.where(np.arange(100_000) < 500, 5e-3, small), False),
                    (np.where(np.arange(100_000) < 50, 5e-2, small), True),
                    (np.where(np.arange(100_000) < 1, 0.1, small), False),
                    (np.where(np.arange(100_000) < 1, np.nan, small), False)):
        failures = []
        with contextlib.redirect_stdout(io.StringIO()):
            gpu_parity._mass_gate(failures, "t", "what", err, 1e-3)
        assert (failures == []) == ok


# the JAX tool's record keys (tools/bench_configs.py:80-95)
CONFIG_KEYS = {"config", "splats", "sh_degree", "resolution", "format",
               "fwd_ms", "fwd_bwd_ms", "fwd_bwd_msplats_per_s"}


@pytest.mark.parametrize("ext,sh", [("ply", 0), ("splat", 1),
                                    ("ksplat", 2)])
def test_bench_configs_run_config(tmp_path, ext, sh):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rec = bench_configs.run_config(f"cfg_{ext}", 300, sh, 64, 64, ext,
                                       str(tmp_path),
                                       check_oracle=ext == "ply",
                                       device="cpu")
    assert json.loads(out.getvalue()) == rec
    keys = CONFIG_KEYS | ({"max_err_vs_oracle", "oracle_ok",
                           "p999_err_vs_oracle",
                           "share_over_1e-2_vs_oracle"}
                          if ext == "ply" else set())
    assert set(rec) == keys
    assert rec["sh_degree"] == (0 if ext == "splat" else sh)
    assert rec["format"] == ext and rec["resolution"] == "64x64"
    assert rec["fwd_ms"] > 0 and rec["fwd_bwd_ms"] > 0
    if ext == "ply":
        assert rec["oracle_ok"] is True


def test_bench_configs_run_config_at_tile_64(tmp_path):
    """accept1's run at tile 64 (the tools' --tile reaches RenderConfig,
    with no check of their own): the oracle gate holds."""
    with contextlib.redirect_stdout(io.StringIO()):
        rec = bench_configs.run_config("cfg_t64", 300, 0, 128, 96, "ply",
                                       str(tmp_path), check_oracle=True,
                                       device="cpu", tile_size=64)
    assert rec["resolution"] == "128x96" and rec["oracle_ok"] is True


def test_train_scene_loads_a_scene_and_saves_the_fit(tmp_path):
    truth = gt.random_splats(torch.Generator().manual_seed(3), 300,
                             device="cpu")
    gt.save(truth, str(tmp_path / "truth.ply"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train_scene.main([
            "--scene", str(tmp_path / "truth.ply"),
            "--save", str(tmp_path / "fit.ksplat"), "--cpu", "--views", "2",
            "--iters", "2", "--init", "200", "--width", "32", "--height",
            "32", "--densify-every", "0", "--log-every", "1"])
    assert rc == 0
    assert "of 300 ground-truth splats on cpu" in out.getvalue()
    fit = gt.load(str(tmp_path / "fit.ksplat"), device="cpu")
    assert fit.num_splats == 200
    assert bool(torch.isfinite(fit.means).all())


def test_utils_metrics_and_logging(tmp_path):
    stats = metrics.FrameStats(wall_ms=4.0, num_splats=2_000_000)
    assert stats.msplats_per_s == 500.0
    assert stats.as_dict()["msplats_per_s"] == 500.0
    assert metrics.FrameStats().msplats_per_s == 0.0
    with metrics.Timer() as t:
        t.block_on(torch.ones(3))
    assert t.ms > 0.0

    s = gt.random_splats(torch.Generator().manual_seed(1), 200,
                         device="cpu")
    cam = gt.Camera.look_at((2.5, 1.5, 2.5), (0, 0, 0), device="cpu")
    cfg = gt.RenderConfig(width=48, height=32)
    out, stats = metrics.timed_render(gt.render, s, cam, cfg,
                                      return_aux=True)
    assert (stats.height, stats.width) == (32, 48)
    assert stats.num_pairs == int(out["num_pairs"]) > 0
    assert stats.overflow == 0 and stats.wall_ms > 0.0

    with metrics.profile_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0

    logger = glog.get_logger()
    try:
        for level, want in ((LogLevel.DEBUG, logging.DEBUG),
                            (LogLevel.NONE, logging.CRITICAL + 10),
                            (logging.INFO, logging.INFO)):
            glog.set_log_level(level)
            assert logger.level == want
    finally:
        glog.set_log_level(LogLevel.WARNING)
    assert logger.name == "gaussiansplats3d_tpu_torch"


def assert_cuda_b5_matches_plain(args):
    """Every B5 variant launched once on the card against its plain
    version: colors and T normalised by the plain max, p99.9 <= 1e-3 and
    <= 0.1% over 1e-2; exit_k equal on >= 99% of tiles."""
    for v in kb.VARIANTS:
        before = metrics.total(kb.LAUNCHES)
        got = kb.variant_cuda(*args, v)
        torch.cuda.synchronize()
        assert metrics.total(kb.LAUNCHES) == before + 1
        ref = kb.composite_variant_torch(*args, v)
        for a, b in zip(got[:2], ref[:2]):
            scale = max(float(b.abs().max()), 1e-30)
            p999, over = error_mass((a / scale).cpu(), (b / scale).cpu())
            assert p999 <= 1e-3 and over <= 1e-3, v
        assert float((got[2] == ref[2]).double().mean()) >= 0.99, v


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [12, 16, 20, 32, 36, 40, 64, 96])
def test_cuda_b5_variants_match_plain(cuda_device, tile):
    """Every B5 variant on the card against its plain version, at tiles
    12, 16, 20 and 32 (128 to 512 threads a block; warp patches cut at
    the tile's edge at 12 and 20), 36, 40 and 64 (a cluster of four
    blocks of 512, with narrow quadrants at 36 and 40) and 96 (one block
    walking 3 x 3 sub-tiles of 32 x 32, each variant with its own vote
    points: exit_k per variant is the plain version's)."""
    arrays = scene_arrays(3000, seed=7, extent=1.0, scale_mul=3.0)
    s = gt.SplatData.from_numpy(*arrays, device=cuda_device)
    cam = gt.Camera.look_at((2.0, 1.2, 2.0), (0, 0, 0), aspect=4 / 3,
                            device=cuda_device)
    cfg = gt.RenderConfig(width=160, height=120, tile_size=tile)
    from gaussiansplats3d_tpu_torch.render.binning import bin_sort_records
    from gaussiansplats3d_tpu_torch.render.projection import project_splats
    with torch.no_grad():
        q = bin_sort_records(project_splats(s, cam, cfg), cfg)
    ids = torch.arange(cfg.num_tiles, dtype=torch.int32, device=cuda_device)
    assert_cuda_b5_matches_plain(
        (q.records, q.tile_starts, q.tile_counts, ids, cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [12, 16, 32, 64, 128])
def test_cuda_b5_pairs_at_warp_edges(cuda_device, tile):
    """Every B5 variant against its plain version on hand-built records
    whose pairs sit just inside and just outside a warp's rectangle
    (edge_records), in windows that start mid-chunk, at 64 across the
    quadrant seams and at 128 across the seams of the sub-tiles a block
    walks."""
    cfg = gt.RenderConfig(width=2 * tile, height=2 * tile, tile_size=tile)
    assert_cuda_b5_matches_plain(
        (*edge_records(cfg, 52 + tile, cuda_device), cfg))


@pytest.mark.cuda
def test_cuda_gpu_parity_rgb_case(cuda_device):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        failures = gpu_parity.run({}, "rgb")
    assert failures == [], out.getvalue()


def test_bench_scene_is_the_bench_scene():
    """kernel_bench and profile_stages share bench.py's scene: random
    splats from seed 0 with scales x0.15 (or x --scale)."""
    cfg = gt.RenderConfig(width=64, height=32)
    s, cam = kb.bench_scene(100, 1, cfg, "cpu")
    ref = gt.random_splats(torch.Generator().manual_seed(0), 100,
                           sh_degree=1, extent=2.0, device="cpu")
    torch.testing.assert_close(s.scales, ref.scales * 0.15)
    torch.testing.assert_close(s.means, ref.means)
    s2, _ = kb.bench_scene(100, 1, cfg, "cpu", scale=0.3)
    torch.testing.assert_close(s2.scales, ref.scales * 0.3)
    torch.testing.assert_close(cam.cam_pos, torch.tensor([4.5, 2.5, 4.5]))
    assert dataclasses.is_dataclass(s)


def _tool_scene(tmp_path, ext, sh_degree):
    """A scene file written by the JAX package from seeded numpy arrays."""
    arrays = scene_arrays(300, sh_degree=sh_degree, seed=4, scale_mul=3.0)
    path = str(tmp_path / f"in.{ext}")
    gs.save(gs.SplatData(*(jnp.asarray(a) for a in arrays)), path)
    return path


@pytest.mark.parametrize("ext,args", [
    ("ply", ["1"]),
    ("splat", ["2", "5", "0,0,0", "4.0", "128"]),
    ("ply", ["0", "1", "0,0,0", "5.0", "256", "1"])])
def test_create_ksplat_matches_the_jax_tool_bytes(tmp_path, monkeypatch,
                                                  ext, args):
    """The port's converter writes the JAX tool's bytes from the same input
    file and arguments (level, alpha threshold, block and bucket size, SH
    degree)."""
    from gaussiansplats3d_tpu.tools import create_ksplat as ck_j
    from gaussiansplats3d_tpu_torch.tools import create_ksplat as ck_t
    monkeypatch.setenv("GS_NATIVE", "0")      # both packages' numpy decoders
    src = _tool_scene(tmp_path, ext, sh_degree=2 if ext == "ply" else 0)
    outs = [str(tmp_path / f"out_{k}.ksplat") for k in ("j", "t")]
    with contextlib.redirect_stdout(io.StringIO()):
        assert ck_j.main([src, outs[0]] + args) == 0
        assert ck_t.main([src, outs[1]] + args) == 0
    data = [open(p, "rb").read() for p in outs]
    assert len(data[1]) > 4096 and data[1] == data[0]


def _read_image(path):
    """A written frame as float32 [H, W, 3] in [0, 1]: the PNG, or the PPM
    a tool writes where PIL is missing."""
    ppm = path.replace(".png", ".ppm")
    if os.path.exists(path):
        from PIL import Image
        img = np.asarray(Image.open(path))
    else:
        with open(ppm, "rb") as f:
            raw = f.read()
        w, h = (int(v) for v in raw.split(b"\n", 1)[0].split()[1:3])
        img = np.frombuffer(raw.split(b"\n", 1)[1], np.uint8).reshape(h, w, 3)
    return img.astype(np.float32) / 255.0


def test_render_scene_cpu_matches_the_jax_tool(tmp_path, monkeypatch):
    """render_scene --cpu writes each orbit frame as the JAX tool does:
    error mass over the 8-bit images, p99.9 of |d| <= 1e-3 and <= 0.1% of
    the values over 1e-2."""
    from gaussiansplats3d_tpu.tools import render_scene as rs_j
    from gaussiansplats3d_tpu_torch.tools import render_scene as rs_t
    monkeypatch.setenv("GS_NATIVE", "0")      # both packages' numpy decoders
    src = _tool_scene(tmp_path, "ksplat", sh_degree=1)
    args = ["--width", "64", "--height", "48", "--sh", "1", "--frames", "2",
            "--orbit-degrees", "40", "--camera", "2.5,1.5,2.5"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert rs_j.main([src, str(tmp_path / "j.png")] + args) in (0, None)
        assert rs_t.main([src, str(tmp_path / "t.png")] + args
                         + ["--cpu"]) == 0
    assert "loaded 300 splats (SH degree 1)" in out.getvalue()
    for f in range(2):
        a = _read_image(str(tmp_path / f"j_{f:04d}.png"))
        b = _read_image(str(tmp_path / f"t_{f:04d}.png"))
        assert a.shape == b.shape == (48, 64, 3)
        assert a.max() > 0.2
        p999, over = error_mass(a, b)
        assert p999 <= 1e-3 and over <= 1e-3, f
