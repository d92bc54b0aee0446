"""The port's multi-device layer (parallel/mesh.py, sharded.py,
distributed.py, the mesh path of train.py, tools/scaling_bench.py and the
slab arguments of binning and surfel binning) against the JAX package and
the port's single-device path, on numpy-made scenes fed to both.

Rank groups: two module fixtures spawn four gloo ranks each on the CPU,
one as a 2x2 (splat, tile) mesh and one as 1x4; every rank runs
tests/torch_sharded_worker.py (torch only), which runs all of its cases
and has rank 0 write what they gathered.  The parametrised tests below
check those results.

Bars:
- Slab binning (tile_range, row_window, depth_bounds, aux_capacity) on the
  JAX package's own projections: starts, counts, total, overflow and every
  in-window record bit for bit, in every record precision; surfels in f32
  and mixed.
- Sharded images against the port's single-device render (the same
  records, tiles and kernels; only the records' slot positions, so the
  128-pair chunks, differ): p99.9 of |d| <= 1e-5 and no pixel over 1e-3;
  against the JAX package's single-device render: max |d| < 2e-3 (as
  tests/test_sharded.py).  overflow 0.
- Gradients of mean(color^2) of the sharded image for the five fields
  against the single-device ones: max |d| / max |single| < 5e-3 (the
  exchange's bfloat16 wire, as tests/test_sharded.py); padded splats'
  gradients exactly 0.
- A tight exchange_capacity=128 at 2x2: overflow, exchange_capacity,
  gathered_records and slab_pairs equal the JAX package's
  sharded_render_tiles stats.
- The train step: the first loss equals the single-device loss to 1e-5
  relative and grad_norm to 5e-3; the loss falls by 10% in 11 steps.
- Checkpoints: the ranks' states come back equal; the .ksplat bytes equal
  the JAX package's save_checkpoint output for the same parameters.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gaussiansplats3d_tpu as gs
import gaussiansplats3d_tpu_torch as gt
from gaussiansplats3d_tpu.parallel import distributed as dist_j
from gaussiansplats3d_tpu.parallel import make_mesh as make_mesh_j
from gaussiansplats3d_tpu.parallel import sharded as sharded_j
from gaussiansplats3d_tpu.parallel import train as train_j
from gaussiansplats3d_tpu.render import binning as bin_j
from gaussiansplats3d_tpu.render import projection as proj_j
from gaussiansplats3d_tpu.render import surfel as surfel_j
from gaussiansplats3d_tpu_torch import parallel as par
from gaussiansplats3d_tpu_torch.parallel import sharded as sharded_t
from gaussiansplats3d_tpu_torch.parallel import train as train_t
from gaussiansplats3d_tpu_torch.render import binning as bin_t
from gaussiansplats3d_tpu_torch.render import cuda_rasterize as cr
from gaussiansplats3d_tpu_torch.render import cuda_surfel as cs
from gaussiansplats3d_tpu_torch.render import projection as proj_t
from gaussiansplats3d_tpu_torch.render import surfel as surfel_t
from gaussiansplats3d_tpu_torch.render.pipeline import render_tiles

import torch_sharded_worker as W
from torch_port_common import (both_scenes, cuda_device,  # noqa: F401
                               error_mass, scene_arrays)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_sharded_worker.py")
GROUPS = ("2x2", "1x4")
COMBOS = [(r, m) for r in W.ROUTES for m in W.SLAB_MODES]
PRECISIONS = ("f32", "mixed", "packed")


# --- slab binning against the JAX package ----------------------------------

BW, BH = 256, 192                       # 8 x 6 tiles of 32
WINDOWS = {
    "band": dict(tile_range=(16, 16)),              # rows 2-3
    "strided": dict(row_window=(1, 3, 2)),          # rows 1 and 4
    "band_aux": dict(tile_range=(8, 24), aux_capacity=256),
}


def _jax_projection(surfel=False):
    s_j, _ = both_scenes(scene_arrays(1500, sh_degree=1, seed=81,
                                      scale_mul=2.0))
    cam = gs.Camera.look_at((2.0, 1.2, 2.0), (0, 0, 0), fov_y_deg=60,
                            aspect=BW / BH)
    cfg = gs.RenderConfig(width=BW, height=BH, sh_degree=1,
                          render_mode_2d=surfel)
    if surfel:
        return surfel_j.project_surfels(s_j, cam, cfg)
    return proj_j.project_splats(s_j, cam, cfg)


@pytest.fixture(scope="module")
def projections():
    return _jax_projection(), _jax_projection(surfel=True)


def _bounds(p):
    d = np.asarray(p.depth)[np.asarray(p.mask)]
    return np.float32(d.min() - 0.25), np.float32(d.max() + 0.5)


def _window_slots(starts, counts):
    return np.concatenate([np.arange(s, s + c) for s, c in
                           zip(starts, counts)] + [np.zeros(0, np.int64)])


def _t(a):
    return torch.from_numpy(np.array(a))


def _check_same(st_t, ct_t, tot_t, ovf_t, rec_t, st_j, ct_j, tot_j, ovf_j,
                rec_j):
    starts, counts = np.asarray(st_j), np.asarray(ct_j)
    np.testing.assert_array_equal(st_t.numpy(), starts)
    np.testing.assert_array_equal(ct_t.numpy(), counts)
    assert int(tot_t) == int(tot_j) and int(ovf_t) == int(ovf_j)
    assert rec_t.shape == rec_j.shape
    slots = _window_slots(starts, counts)
    assert slots.size > 200
    np.testing.assert_array_equal(rec_t[:, slots].view(np.uint32),
                                  rec_j[:, slots].view(np.uint32))
    return int(ovf_j)


@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("prec", PRECISIONS)
def test_slab_binning_matches_jax(projections, prec, window):
    p_j = projections[0]
    dmin, dmax = _bounds(p_j)
    kw = dict(WINDOWS[window])
    cfg_j = gs.RenderConfig(width=BW, height=BH, sh_degree=1,
                            record_precision=prec)
    cfg_t = gt.RenderConfig(width=BW, height=BH, sh_degree=1,
                            record_precision=prec)
    pairs_j = bin_j.bin_sort_records(
        p_j, cfg_j, depth_bounds=(jnp.float32(dmin), jnp.float32(dmax)),
        **kw)
    proj = proj_t.ProjectedSplats(**{
        f: _t(getattr(p_j, f)) for f in (
            "xs", "ys", "conic_a", "conic_b", "conic_c", "col_r", "col_g",
            "col_b", "opacity", "depth", "rx", "ry", "mask")})
    pairs_t = bin_t.bin_sort_records(proj, cfg_t, depth_bounds=(dmin, dmax),
                                     **kw)
    rec_j = np.stack([np.asarray(r) for r in (
        pairs_j.xs, pairs_j.ys, pairs_j.cas, pairs_j.cbs, pairs_j.ccs,
        pairs_j.crs, pairs_j.cgs, pairs_j.cbs2, pairs_j.opas, pairs_j.rxs,
        pairs_j.rys)])
    overflow = _check_same(pairs_t.tile_starts, pairs_t.tile_counts,
                           pairs_t.total_pairs, pairs_t.overflow,
                           pairs_t.records.numpy(), pairs_j.tile_starts,
                           pairs_j.tile_counts, pairs_j.total_pairs,
                           pairs_j.overflow, rec_j)
    assert (overflow > 0) == ("aux_capacity" in kw)


@pytest.mark.parametrize("window", ["band", "strided"])
@pytest.mark.parametrize("prec", ["f32", "mixed"])
def test_slab_surfel_binning_matches_jax(projections, prec, window):
    sp_j = projections[1]
    dmin, dmax = _bounds(sp_j)
    kw = dict(WINDOWS[window])
    cfg_j = gs.RenderConfig(width=BW, height=BH, sh_degree=1,
                            render_mode_2d=True, record_precision=prec)
    cfg_t = gt.RenderConfig(width=BW, height=BH, sh_degree=1,
                            render_mode_2d=True, record_precision=prec)
    recs_j, st_j, ct_j, tot_j, ovf_j = surfel_j.bin_sort_surfels(
        sp_j, cfg_j, depth_bounds=(jnp.float32(dmin), jnp.float32(dmax)),
        **kw)
    sp_t = surfel_t.SurfelProjection(
        t=tuple(_t(v) for v in sp_j.t),
        **{f: _t(getattr(sp_j, f)) for f in ("mean2d", "radius", "color",
                                             "opacity", "depth")},
        mask=_t(sp_j.mask))
    rec_t, st_t, ct_t, tot_t, ovf_t = surfel_t.bin_sort_surfels(
        sp_t, cfg_t, depth_bounds=(dmin, dmax), **kw)
    _check_same(st_t, ct_t, tot_t, ovf_t, rec_t.numpy(), st_j, ct_j, tot_j,
                ovf_j, np.asarray(recs_j).T)


def test_quantize_depth_bounds_and_tile_orders_match_jax(projections):
    p_j = projections[0]
    dmin, dmax = _bounds(p_j)
    q_j = proj_j.quantize_depth(p_j.depth, p_j.mask, 20,
                                (jnp.float32(dmin), jnp.float32(dmax)))
    q_t = proj_t.quantize_depth(_t(p_j.depth), _t(p_j.mask), 20,
                                (dmin, dmax))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    x = np.random.default_rng(82).normal(size=(48, 3, 5)).astype(np.float32)
    inter = sharded_t.interleave_tile_order(torch.from_numpy(x), 3, 4)
    np.testing.assert_array_equal(
        inter.numpy(),
        np.asarray(sharded_j.interleave_tile_order(jnp.asarray(x), 3, 4)))
    np.testing.assert_array_equal(
        sharded_t.deinterleave_tile_order(inter, 3, 4).numpy(), x)
    for n_local, t, alpha in ((1000, 2, 3.0), (50_000, 4, 4.0), (10, 1, 3.0)):
        cfg_j = gs.RenderConfig(width=BW, height=BH)
        cfg_t = gt.RenderConfig(width=BW, height=BH)
        assert sharded_t.default_exchange_capacity(cfg_t, n_local, t, alpha) \
            == sharded_j.default_exchange_capacity(cfg_j, n_local, t, alpha)


@pytest.mark.parametrize("surfel,depth,shards", [
    (False, False, 2), (False, True, 3), (True, False, 2), (True, True, 3)],
    ids=["3d", "3d-depth", "2d", "2d-depth"])
def test_exchange_backward_wire_matches_jax(surfel, depth, shards):
    """The exchange's backward wire: the centre's cotangent rows go out in
    float32 and the rest of the differentiable prefix in bfloat16, divided
    by the splat group's size, bit for bit as the JAX package's
    _ct_wire_split sends the same (averaged) cotangents."""
    cfg_t = gt.RenderConfig(width=BW, height=BH, render_mode_2d=surfel,
                            return_depth=depth)
    cfg_j = gs.RenderConfig(width=BW, height=BH, render_mode_2d=surfel,
                            return_depth=depth)
    n_wire, n_diff, exact = sharded_t.exchange_plan(cfg_t)
    n_diff_j, _, exact_j = sharded_j.exchange_plan(cfg_j, surfel)
    assert (n_diff, tuple(exact)) == (n_diff_j, tuple(exact_j))
    rng = np.random.default_rng(83)
    g = (rng.normal(size=(n_wire, 96))
         * 10.0 ** rng.uniform(-30, 30, size=(n_wire, 96))).astype(np.float32)
    wire = sharded_t._Wire(96, n_diff, exact, None, shards)
    ex, rest, f32, bf16 = wire.split(torch.from_numpy(g))
    ex_j, rest_j, f32_j, bf16_j = sharded_j._ct_wire_split(
        jnp.asarray(g / np.float32(shards)), n_diff_j, exact_j)
    assert (list(ex), list(rest)) == (list(ex_j), list(rest_j))
    assert list(ex) == list(exact)[:2] and len(ex) + len(rest) == n_diff
    assert (f32.dtype, bf16.dtype) == (torch.float32, torch.bfloat16)
    np.testing.assert_array_equal(f32.numpy(), np.asarray(f32_j))
    np.testing.assert_array_equal(bf16.float().numpy(),
                                  np.asarray(bf16_j.astype(jnp.float32)))
    assert not np.array_equal(bf16.float().numpy(),
                              g[rest] / np.float32(shards))


# --- the rank groups -------------------------------------------------------

def _spawn_group(shape, tmp_path_factory):
    out = tmp_path_factory.mktemp(f"group_{shape}")
    store = f"file://{out}/store"
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), "4", shape,
                               store, str(out)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env)
             for r in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-6000:]
    with np.load(out / "results.npz") as data:
        return out, {k: data[k] for k in data.files}


@pytest.fixture(scope="module")
def group_2x2(tmp_path_factory):
    return _spawn_group("2x2", tmp_path_factory)


@pytest.fixture(scope="module")
def group_1x4(tmp_path_factory):
    return _spawn_group("1x4", tmp_path_factory)


@pytest.fixture(params=GROUPS)
def group(request):
    return request.getfixturevalue(f"group_{request.param}")


def _single(splats, cfg, cam=None, **kw):
    with torch.no_grad():
        return gt.render(splats, cam or W.camera(), cfg, **kw)


def _close_to_single(out, ref, keys=("color", "alpha")):
    for k in keys:
        p999, _ = error_mass(out[k], ref[k].numpy())
        worst = float(np.abs(out[k] - ref[k].numpy()).max())
        assert p999 <= 1e-5 and worst <= 1e-3, (k, p999, worst)


@pytest.fixture(scope="module")
def jax_render():
    s_j, _ = both_scenes(scene_arrays(512, sh_degree=1, seed=3))
    cfg = gs.RenderConfig(width=128, height=128, sh_degree=1, sort_bits=20,
                          tile_size=16, background=W.CFG.background)
    cam = gs.Camera.look_at(W.EYE, (0, 0, 0), fov_y_deg=60, aspect=1.0)
    return {k: np.asarray(v) for k, v in gs.render(s_j, cam, cfg).items()}


@pytest.fixture(scope="module")
def single_3d():
    return _single(W.scene(512, 3), W.CFG)


@pytest.mark.parametrize("route,mode", COMBOS)
def test_sharded_render_matches_single_device(group, single_3d, jax_render,
                                              route, mode):
    _, res = group
    out = {k: res[f"render/{route}/{mode}/{k}"] for k in ("color", "alpha",
                                                          "overflow")}
    assert int(out["overflow"]) == 0
    _close_to_single(out, single_3d)
    for k in ("color", "alpha"):
        assert float(np.abs(out[k] - jax_render[k]).max()) < 2e-3, k


@pytest.fixture(scope="module")
def single_grads():
    s = W.scene(300, 4)
    for f in W.FIELDS:
        getattr(s, f).requires_grad_(True)
    (gt.render(s, W.camera(), W.CFG)["color"] ** 2).mean().backward()
    return {f: getattr(s, f).grad.numpy() for f in W.FIELDS}


@pytest.mark.parametrize("route,mode", COMBOS)
def test_sharded_gradients_match_single_device(group, single_grads, route,
                                               mode):
    _, res = group
    for f in W.FIELDS:
        a, b = res[f"grad/{route}/{mode}/{f}"], single_grads[f]
        scale = max(float(np.abs(b).max()), 1e-8)
        assert float(np.abs(a - b).max()) / scale < 5e-3, f
        assert np.all(res[f"grad/{route}/{mode}/pad/{f}"] == 0.0), f


@pytest.mark.parametrize("key,splats,cfg", [
    ("render2d/gather/banded", lambda: W.scene(400, 5, flat=True),
     W.CFG.replace(render_mode_2d=True)),
    ("render2d/a2a/interleaved", lambda: W.scene(400, 5, flat=True),
     W.CFG.replace(render_mode_2d=True)),
    ("packed/gather/banded", lambda: W.scene(400, 9, big_every=7),
     W.CFG.replace(record_precision="packed", forward_only=True)),
    ("packed/a2a/interleaved", lambda: W.scene(400, 9, big_every=7),
     W.CFG.replace(record_precision="packed", forward_only=True)),
    ("depth/gather/banded", lambda: W.scene(400, 6),
     W.CFG.replace(return_depth=True)),
], ids=["2d-gather-banded", "2d-a2a-interleaved", "packed-gather-banded",
        "packed-a2a-interleaved", "depth"])
def test_sharded_modes_match_single_device(group, key, splats, cfg):
    """The 2D surfel mode, the packed serving precision with big splats
    straddling slabs (the touch filter reads the decoded radius and the
    quantised y), and the depth channel."""
    _, res = group
    ref = _single(splats(), cfg)
    keys = ("color", "alpha", "depth") if cfg.return_depth else (
        "color", "alpha")
    out = {k: res[f"{key}/{k}"] for k in keys}
    assert int(res[f"{key}/overflow"]) == 0
    _close_to_single(out, ref, keys)
    assert float(out["alpha"].max()) > 0.5


def test_sharded_multi_scene_stereo(group):
    _, res = group
    splats, idx, tfs, opac, vis = W.stereo_scene()
    eyes = {}
    for eye, dx in (("left", -0.15), ("right", 0.15)):
        cam = W.camera((W.EYE[0] + dx, W.EYE[1], W.EYE[2]))
        ref = _single(splats, W.CFG, cam, transforms=tfs,
                      scene_indices=idx, scene_opacities=opac,
                      scene_visibility=vis)
        out = {k: res[f"stereo/{eye}/{k}"] for k in ("color", "alpha")}
        assert int(res[f"stereo/{eye}/overflow"]) == 0
        _close_to_single(out, ref)
        eyes[eye] = out["color"]
    assert float(np.abs(eyes["left"] - eyes["right"]).max()) > 1e-2


def test_tight_exchange_stats_match_jax(group_2x2):
    _, res = group_2x2
    s_j, _ = both_scenes(scene_arrays(2048, sh_degree=1, seed=7))
    cfg = gs.RenderConfig(width=128, height=128, sh_degree=1, sort_bits=20,
                          tile_size=16, background=W.CFG.background)
    cam = gs.Camera.look_at(W.EYE, (0, 0, 0), fov_y_deg=60, aspect=1.0)
    mesh = make_mesh_j(jax.devices()[:4], splat_shards=2, tile_shards=2)
    stats = jax.jit(lambda s: sharded_j.sharded_render_tiles(
        mesh, s, cam, cfg, exchange_capacity=128, return_stats=True)[1])(
        sharded_j.device_put_sharded_splats(s_j, mesh))
    assert int(stats["overflow"]) > 0
    for k in ("overflow", "exchange_capacity", "gathered_records",
              "slab_pairs"):
        np.testing.assert_array_equal(res[f"tight/{k}"],
                                      np.asarray(stats[k]), err_msg=k)
    assert int(res["tight/exchange_wire_ops"]) == 12


def test_sharded_train_step_matches_single_device(group):
    _, res = group
    key = [k for k in res if k.startswith("train/")][0].rsplit("/", 1)[0]
    losses, norms = res[f"{key}/losses"], res[f"{key}/grad_norms"]
    target = _single(W.scene(256, 11), W.CFG)["color"]
    tiles, mask = train_t.image_to_tile_blocks(target, W.CFG)
    state = train_t.TrainState.create(W.scene(256, 12), train_t.adam(W.LR))
    step = train_t.make_train_step(W.CFG, None, train_t.adam(W.LR))
    _, m = step(state, W.camera(), tiles, mask)
    np.testing.assert_allclose(losses[0], float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(norms[0], float(m["grad_norm"]), rtol=5e-3)
    assert np.all(np.isfinite(losses))
    assert losses[-1] < 0.9 * losses[0], losses


def _jax_state(params):
    p = train_j.SplatParams(**{f: jnp.asarray(params[f])
                               for f in train_t.SplatParams.FIELDS})
    return train_j.TrainState(params=p, opt_state=optax.adam(W.LR).init(p),
                              step=jnp.zeros((), jnp.int32))


def test_checkpoint_under_mesh_round_trips_and_matches_jax(group_2x2,
                                                           tmp_path):
    out, res = group_2x2
    assert int(res["ckpt/equal"]) == 1
    with np.load(out / "ckpt.opt.npz") as data:
        params = {f: data[f"params.{f}"] for f in train_t.SplatParams.FIELDS}
        assert int(data["step"]) == W.TRAIN_STEPS
    dist_j.save_checkpoint(_jax_state(params), str(tmp_path / "jax"),
                           compression_level=1)
    assert (out / "ckpt.ksplat").read_bytes() == \
        (tmp_path / "jax.ksplat").read_bytes()


def test_checkpoint_round_trip_matches_jax_bytes(tmp_path):
    state = train_t.TrainState.create(W.scene(200, 13), train_t.adam(W.LR))
    step = train_t.make_train_step(W.CFG, None, train_t.adam(W.LR))
    target = _single(W.scene(200, 14), W.CFG)["color"]
    state, _ = step(state, W.camera(), *train_t.image_to_tile_blocks(
        target, W.CFG))
    par.save_checkpoint(state, str(tmp_path / "port"), compression_level=1)
    back = par.load_checkpoint(str(tmp_path / "port"), train_t.adam(W.LR),
                               device="cpu")
    assert back.step == state.step == 1
    for f in train_t.SplatParams.FIELDS:
        a, b = getattr(state.params, f), getattr(back.params, f)
        assert torch.equal(a, b), f
        sa, sb = state.opt_state.state[a], back.opt_state.state[b]
        assert set(sa) == set(sb) and all(torch.equal(sa[k], sb[k])
                                          for k in sa), f
    params = {f: getattr(state.params, f).detach().numpy()
              for f in train_t.SplatParams.FIELDS}
    dist_j.save_checkpoint(_jax_state(params), str(tmp_path / "jax"),
                           compression_level=1)
    assert (tmp_path / "port.ksplat").read_bytes() == \
        (tmp_path / "jax.ksplat").read_bytes()
    # the .ksplat alone resumes: the splats it holds
    (tmp_path / "port.opt.npz").unlink()
    alone = par.load_checkpoint(str(tmp_path / "port"), train_t.adam(W.LR),
                                device="cpu")
    assert alone.step == 0 and alone.params.num_splats == 200


def test_scaling_bench_asserts_volumes_on_a_cpu_group(group_2x2):
    import json
    out, _ = group_2x2
    report = json.loads((out / "scaling.json").read_text())
    rows = {r["mesh"]: r for r in report["results"]}
    assert set(rows) == {"1x1", "2x1", "1x2", "2x2"}
    assert report["platform"] == "cpu" and report["ranks"] == 4
    assert all(r["overflow"] == 0 for r in rows.values())
    assert rows["2x2"]["gathered_records_per_device"] < \
        rows["2x1"]["gathered_records_per_device"]


def test_scaling_bench_spawns_its_ranks(capfd):
    """Without a process group or torchrun's environment, scaling_bench
    spawns the gloo ranks its largest shape needs and joins them."""
    import json
    from gaussiansplats3d_tpu_torch.tools import scaling_bench
    code = scaling_bench.main(["2000", "--meshes", "1x1,2x1", "--width",
                               "64", "--height", "32", "--iters", "1",
                               "--cpu", "--assert-volumes"])
    out = capfd.readouterr().out
    assert code == 0, out
    report = json.loads([ln for ln in out.splitlines()
                         if ln.startswith('{"metric"')][-1])
    assert report["ranks"] == 2
    assert [r["mesh"] for r in report["results"]] == ["1x1", "2x1"]
    assert "volume asserts OK" in out


def test_initialize_distributed_and_make_mesh(monkeypatch, tmp_path):
    import torch.distributed as dist
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert par.initialize_distributed(device="cpu") is False
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        par.initialize_distributed(f"file://{tmp_path}/s", 1, device="cpu")
    with pytest.raises(RuntimeError):
        par.make_mesh("cpu")
    assert par.initialize_distributed(f"file://{tmp_path}/store", 1, 0,
                                      device="cpu") is False
    try:
        mesh = par.make_mesh("cpu")
        assert mesh.mesh_dim_names == ("splat", "tile")
        assert tuple(mesh.shape) == (1, 1)
        with pytest.raises(ValueError):
            par.make_mesh("cpu", splat_shards=2)
    finally:
        dist.destroy_process_group()


# --- the kernels on slab tile ids (the card) -------------------------------

def _slab_case(device, tile, mode, surfel):
    # aux slots for every big splat's pairs: the whole frame must drop none
    # for its chans to equal the slabs'
    cfg = gt.RenderConfig(width=320, height=256, sh_degree=1, tile_size=tile,
                          render_mode_2d=surfel, sort_bits=16,
                          aux_multiplier=4.0)
    s = gt.SplatData.from_numpy(*scene_arrays(3000, sh_degree=1, seed=90),
                                device=device)
    cam = gt.Camera.look_at((2.2, 1.4, 2.0), (0, 0, 0), fov_y_deg=60,
                            aspect=320 / 256, device=device)
    return s, cam, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("surfel", [False, True], ids=["3d", "2d"])
@pytest.mark.parametrize("mode", ["banded", "interleaved"])
@pytest.mark.parametrize("tile", [16, 32])
def test_cuda_slab_kernels_match_plain(cuda_device, tile, mode, surfel):
    """B1/B2 (B3/B4 in 2D) on each slab's records of a (1, 4)
    decomposition, with banded or strided global tile ids, against their
    plain versions; the stitched slabs equal the single-device render."""
    s, cam, cfg = _slab_case(cuda_device, tile, mode, surfel)
    with torch.no_grad():
        project = (surfel_t.project_surfels if surfel
                   else proj_t.project_splats)
        proj = project(s, cam, cfg)
        d = proj.depth[proj.mask]
        bounds = (d.min(), d.max())
        slabs = [sharded_t.render_slab(
            cfg, *sharded_t.slab_rows(cfg, proj, j, 4, mode, s.num_splats),
            j, 4, mode, bounds) for j in range(4)]
        whole, _, overflow = render_tiles(s, cam, cfg)
    assert int(overflow) == 0 and all(int(sl.overflow) == 0 for sl in slabs)
    fwd = cs.composite_surfel_fwd if surfel else cr.composite_fwd
    bwd = cs.composite_surfel_bwd if surfel else cr.composite_bwd
    gen = torch.Generator().manual_seed(91)
    for slab in slabs:
        ins = (slab.records, slab.tile_starts, slab.tile_counts,
               slab.tile_ids)
        out = fwd(*ins, cfg)
        ref = fwd(*(x.cpu() for x in ins), cfg)
        for a, b in zip(out[:2], ref[:2]):
            p999, over = error_mass(a.cpu().numpy(), b.numpy(), 1e-3)
            assert p999 <= 1e-4 and over <= 1e-3, (p999, over)
        cot = [torch.randn(out[0].shape, generator=gen)]
        if surfel:
            cot.append(torch.zeros(out[1].shape))
        g = bwd(*ins, out[1], out[2], *(c.to(cuda_device) for c in cot), cfg)
        g_ref = bwd(*(x.cpu() for x in ins), ref[1], ref[2], *cot, cfg)
        for row in range(g.shape[0]):
            scale = max(float(g_ref[row].abs().max()), 1e-12)
            p999, _ = error_mass(g[row].cpu().numpy() / scale,
                                 g_ref[row].numpy() / scale)
            assert p999 <= 1e-3, (row, p999)
    chans = torch.cat([sl.chans for sl in slabs])
    if mode == "interleaved":
        chans = sharded_t.deinterleave_tile_order(chans, 4, cfg.tiles_x)
    p999, over = error_mass(chans.cpu().numpy(), whole.cpu().numpy())
    assert p999 <= 1e-4 and over <= 1e-4, (p999, over)
