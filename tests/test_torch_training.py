"""Training on the port (parallel/train.py, parallel/heuristics.py,
utils/image_metrics.py, tools/train_scene.py) against the JAX package, on
numpy-made scenes fed to both.

Bars:
- SplatParams: from_numpy carries the JAX leaves bit for bit; from_splats
  and to_splats agree to 1e-6 (sigmoid, log and exp round differently).
- Train step: make_train_step against the JAX package's own
  make_train_step on a 1-device CPU mesh (its sharded path agrees with
  jax.value_and_grad over gs.render's chans here, so no fallback is
  needed): loss and grad_norm to 1e-5 relative at each of 3 steps; the
  parameters after 3 Adam steps by error mass, p99 of |d| <= 2e-2 of the
  largest possible move (3 lr).  Adam divides each gradient by its own
  running RMS, so an element whose gradient is near 0 (a quaternion's
  radial component, which the renderer's normalisation cancels up to
  rounding) moves by up to lr on rounding alone.
- densify_and_prune: the same parameters to 1e-6, given the same split
  draws, on tie-free inputs and with tied dead slots.
- psnr / ssim / d_ssim_l1_loss: 1e-5.
- The fit gate: >= 25 dB, as tests/test_training.py::test_fit_psnr_gate."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gaussiansplats3d_tpu as gs
import gaussiansplats3d_tpu_torch as gt
from gaussiansplats3d_tpu.parallel import heuristics as heur_j
from gaussiansplats3d_tpu.parallel import make_mesh
from gaussiansplats3d_tpu.parallel import train as train_j
from gaussiansplats3d_tpu.utils import image_metrics as metrics_j
from gaussiansplats3d_tpu_torch.parallel import heuristics as heur_t
from gaussiansplats3d_tpu_torch.parallel import train as train_t
from gaussiansplats3d_tpu_torch.render.pipeline import (render_batch,
                                                        stack_cameras)
from gaussiansplats3d_tpu_torch.tools import train_scene
from gaussiansplats3d_tpu_torch.utils import image_metrics as metrics_t

from torch_port_common import both_cameras, both_scenes, scene_arrays

FIELDS = train_t.SplatParams.FIELDS


def _leaves(p):
    return [np.asarray(getattr(p, f).detach() if isinstance(
        getattr(p, f), torch.Tensor) else getattr(p, f)) for f in FIELDS]


def test_splat_params_from_numpy_and_splats_match_jax():
    s_j, s_t = both_scenes(scene_arrays(200, sh_degree=1, seed=50))
    p_j = train_j.SplatParams.from_splats(s_j)
    p_t = train_t.SplatParams.from_numpy(*_leaves(p_j), device="cpu")
    for a, b in zip(_leaves(p_t), _leaves(p_j)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_leaves(train_t.SplatParams.from_splats(s_t)),
                    _leaves(p_j)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)
    assert all(isinstance(p, torch.nn.Parameter) for p in p_t.parameters())
    sp_j, sp_t = p_j.to_splats(), p_t.to_splats()
    for f in ("means", "scales", "quats", "colors", "sh"):
        np.testing.assert_allclose(getattr(sp_t, f).detach().numpy(),
                                   np.asarray(getattr(sp_j, f)),
                                   atol=1e-6, rtol=1e-6)


def test_train_step_matches_jax():
    cfg_t, lr = _assert_steps_match_jax(
        dict(width=64, height=64, sh_degree=1, sort_bits=16), steps=3)
    # the mesh's own arguments need a mesh (tests/test_torch_sharded.py
    # drives the mesh path)
    for kw in (dict(route="a2a"), dict(slab_mode="interleaved"),
               dict(exchange_capacity=256)):
        with pytest.raises(ValueError):
            train_t.make_train_step(cfg_t, None, train_t.adam(lr), **kw)


def test_train_step_matches_jax_at_tile_64():
    """One step at tile 64 (128 x 128: 2 x 2 tiles; on a card B1 and B2
    run as clusters of four 32 x 32 blocks), under the same bars."""
    _assert_steps_match_jax(dict(width=128, height=128, tile_size=64,
                                 sh_degree=1, sort_bits=16), steps=1)


def _assert_steps_match_jax(kw, steps):
    """``steps`` steps of make_train_step against the JAX package's on a
    1-device mesh from the same 256 splats and target: loss and grad_norm
    at each, the parameters after the last.  Returns (port cfg, lr)."""
    s_j, s_t = both_scenes(scene_arrays(256, sh_degree=1, seed=51))
    cam_j, cam_t = both_cameras(gs.Camera.look_at((2.2, 1.4, 2.0),
                                                  (0, 0, 0)))
    cfg_j, cfg_t = gs.RenderConfig(**kw), gt.RenderConfig(**kw)
    target = np.random.default_rng(52).uniform(
        0.0, 1.0, (kw["height"], kw["width"], 3)).astype(np.float32)
    lr = 1e-2

    opt = optax.adam(lr)
    state_j = train_j.TrainState.create(s_j, opt)
    step_j = jax.jit(train_j.make_train_step(
        cfg_j, make_mesh(jax.devices()[:1], 1, 1), opt))
    tiles_j, mask_j = train_j.image_to_tile_blocks(jnp.asarray(target), cfg_j)
    state_t = train_t.TrainState.create(s_t, train_t.adam(lr))
    step_t = train_t.make_train_step(cfg_t, None, train_t.adam(lr))
    tiles_t, mask_t = train_t.image_to_tile_blocks(torch.tensor(target),
                                                   cfg_t)
    np.testing.assert_array_equal(tiles_t.numpy(), np.asarray(tiles_j))
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    for _ in range(steps):
        state_j, m_j = step_j(state_j, cam_j, tiles_j, mask_j)
        state_t, m_t = step_t(state_t, cam_t, tiles_t, mask_t)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]),
                                       rtol=1e-5)
    assert state_t.step == int(state_j.step) == steps
    for f, a, b in zip(FIELDS, _leaves(state_t.params),
                       _leaves(state_j.params)):
        d = np.abs(a - b).ravel() / (steps * lr)
        assert np.quantile(d, 0.99) <= 2e-2, (f, np.quantile(d, 0.99))
        assert d.max() <= 1.0, f
    return cfg_t, lr


def _densify_inputs(n, seed, tied_dead):
    """Parameters with 80 dead slots and ~100 hot splats of distinct
    average gradients, half of them big (split) and half small (clone)."""
    rng = np.random.default_rng(seed)
    p = train_j.SplatParams.from_splats(gs.SplatData(*(jnp.asarray(a) for a in
                                                        scene_arrays(n, 1, seed))))
    lo = rng.uniform(1.0, 3.0, n)
    lo[:80] = -12.0 if tied_dead else rng.uniform(-11.0, -6.0, 80)
    ls = np.log(rng.uniform(0.002, 0.009, (n, 3)))   # below 0.01: clone
    ls[80:130] = np.log(rng.uniform(0.02, 0.05, (50, 3)))
    p = dataclasses.replace(p, logit_opacity=jnp.asarray(lo, jnp.float32),
                            log_scales=jnp.asarray(ls, jnp.float32))
    grads = np.zeros((n, 3), np.float32)
    grads[80:180] = rng.normal(0.0, 1.0, (100, 3))
    st = heur_j.DensifyState.create(n).update(jnp.asarray(grads))
    st_t = heur_t.DensifyState.create(n, device="cpu").update(
        torch.tensor(grads))
    return p, st, st_t


@pytest.mark.parametrize("tied_dead", [False, True])
def test_densify_and_prune_matches_jax(tied_dead):
    n = 256
    p_j, st_j, st_t = _densify_inputs(n, 53, tied_dead)
    cfg = dict(grad_threshold=1e-3, budget_per_step=64, scene_extent=1.0)
    key = jax.random.PRNGKey(7)
    new_j, rs_j = heur_j.densify_and_prune(p_j, st_j, key,
                                           heur_j.DensifyConfig(**cfg))
    noise = np.asarray(jax.random.normal(key, (64, 3)))
    p_t = train_t.SplatParams.from_numpy(*_leaves(p_j), device="cpu")
    new_t, rs_t = heur_t.densify_and_prune(
        p_t, st_t, torch.Generator().manual_seed(0),
        heur_t.DensifyConfig(**cfg), noise=torch.tensor(noise))
    # both branches ran: split sources shrank, clones kept their scale
    shrunk = np.asarray(new_j.log_scales)[80:180] < _leaves(p_j)[1][80:180]
    assert 0 < shrunk.all(axis=1).sum() < 100
    for f, a, b in zip(FIELDS, _leaves(new_t), _leaves(new_j)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6, err_msg=f)
    alive = int(heur_t.num_alive(new_t))
    assert alive == int(heur_j.num_alive(new_j)) > int(heur_t.num_alive(p_t))
    assert float(rs_t.grad_accum.abs().sum()) == 0.0
    assert int(rs_t.count.sum()) == 0
    # the generator path draws its own noise: same shapes, clones equal
    new_g, _ = heur_t.densify_and_prune(
        p_t, st_t, torch.Generator().manual_seed(0),
        heur_t.DensifyConfig(**cfg))
    assert int(heur_t.num_alive(new_g)) == alive


def test_image_metrics_match_jax():
    rng = np.random.default_rng(54)
    a = rng.uniform(0.0, 1.0, (40, 52, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0.0, 0.1, a.shape), 0.0, 1.0).astype(
        np.float32)
    for name in ("psnr", "ssim", "d_ssim_l1_loss"):
        got = float(getattr(metrics_t, name)(torch.tensor(a),
                                              torch.tensor(b)))
        ref = float(getattr(metrics_j, name)(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(got, ref, rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(
        float(metrics_t.ssim(torch.tensor(a[..., 0]), torch.tensor(b[..., 0]))),
        float(metrics_j.ssim(jnp.asarray(a[..., 0]), jnp.asarray(b[..., 0]))),
        rtol=1e-5)


def test_fit_psnr_gate():
    """The port's counterpart of tests/test_training.py::test_fit_psnr_gate:
    recover a perturbed 300-splat scene to >= 25 dB over 3 views in 150
    Adam steps (lr 2e-3), through render_batch and the plain B1/B2."""
    arrays = scene_arrays(300, sh_degree=0, seed=55)
    truth = gt.SplatData.from_numpy(*arrays, device="cpu")
    cfg = gt.RenderConfig(width=64, height=64, sort_bits=14)
    cams = stack_cameras([
        gt.Camera.look_at(eye, (0, 0, 0), fov_y_deg=60.0, device="cpu")
        for eye in ((2.0, 1.0, 2.0), (-2.0, 1.2, 1.8), (0.5, 2.4, -1.8))])
    with torch.no_grad():
        targets = render_batch(truth, cams, cfg)["color"]
    rng = np.random.default_rng(56)
    init = gt.SplatData.from_numpy(
        arrays[0] + 0.03 * rng.normal(size=arrays[0].shape), *arrays[1:3],
        np.clip(arrays[3] + 0.15 * rng.normal(size=arrays[3].shape),
                0.01, 1.0), arrays[4], device="cpu")
    params = train_t.SplatParams.from_splats(init)
    opt = train_t.adam(2e-3)(params.parameters())
    for _ in range(150):
        opt.zero_grad()
        out = render_batch(params.to_splats(), cams, cfg)["color"]
        torch.mean((out - targets) ** 2).backward()
        opt.step()
    with torch.no_grad():
        final = render_batch(params.to_splats(), cams, cfg)["color"]
    p = float(metrics_t.psnr(final, targets))
    assert p >= 25.0, f"fit PSNR {p:.2f} dB < 25 dB"


def test_train_scene_cli_runs_on_cpu(capsys, tmp_path):
    fit = str(tmp_path / "fit.ksplat")
    assert train_scene.main(["--cpu", "--views", "2", "--iters", "4",
                             "--init", "200", "--width", "32", "--height",
                             "32", "--densify-every", "2",
                             "--log-every", "2", "--save", fit]) == 0
    out = capsys.readouterr().out
    assert "on cpu" in out and "final psnr(view0)" in out
    assert f"saved {fit}" in out
    # the saved fit is a scene the CLI can start from
    assert train_scene.main(["--cpu", "--views", "2", "--iters", "1",
                             "--init", "100", "--width", "32", "--height",
                             "32", "--densify-every", "0",
                             "--scene", fit]) == 0
    assert "of 200 ground-truth splats" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        train_scene.main(["--cpu", "--scene", str(tmp_path / "none.ply")])
