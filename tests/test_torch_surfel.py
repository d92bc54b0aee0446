"""The 2DGS surfel mode of the port (render/surfel.py and the 2D routes of
render/pipeline.py and parallel/train.py) against the JAX package's
render/surfel.py, gs.render in 2D (backend "pallas", the Pallas kernels in
interpret mode) and the JAX package's make_train_step, on numpy-made
scenes fed to both.

Bars:
- Projection: every field of SurfelProjection, |d| normalised by the
  field's max |JAX| <= 1e-5, the mask equal; the radii, ceiled to 1/16 px
  from a cancelling difference (cx^2 - tmp), equal but for one 1/16 step
  on at most 0.5% of the surfels.  Its gradients, through a weighted sum
  of every field, against jax.grad for the five SplatData fields:
  normalised p99.9 <= 1e-4.
- Binning (on the JAX package's own projection): starts, counts, total,
  overflow and every in-window record bit for bit, in f32, mixed and
  packed, with and without depth, with forward_only (surfel ties always
  break by slot) and zoomed in until the aux capacity overflows.
  Gradients of a weighted sum of the in-window records: normalised p99.9
  <= 1e-5 in f32; <= 1e-2 in mixed and packed (the JAX package rounds
  every cotangent but t00's and t01's to bf16, a relative 2^-9 per pair).
- Render: images p99.9 of |d| <= 1e-3 and <= 0.1% of pixels over 1e-2;
  render_2d against the JAX render_2d the same.  Gradients of an image
  loss, per SplatData field normalised by its max |JAX|: p99.9 <= 1e-3 in
  f32, <= 1e-2 in mixed.  scales[:, 2], which surfels never read, gets a
  gradient of exactly 0.
- The 2D training step against the JAX package's make_train_step on a
  1-device mesh, f32 records: the loss to 1e-5 relative at each of 3 steps;
  grad_norm to 1e-3 relative (the JAX step's exchange rounds every
  cotangent but the center's to bf16); the parameters after 3 Adam steps
  by error mass, as tests/test_torch_training.py holds the 3D step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gaussiansplats3d_tpu as gs
import gaussiansplats3d_tpu_torch as gt
from gaussiansplats3d_tpu.parallel import make_mesh
from gaussiansplats3d_tpu.parallel import train as train_j
from gaussiansplats3d_tpu.render import surfel as surfel_j
from gaussiansplats3d_tpu_torch.parallel import train as train_t
from gaussiansplats3d_tpu_torch.render import pipeline as pipe_t
from gaussiansplats3d_tpu_torch.render import surfel as surfel_t

from torch_port_common import (both_cameras, both_scenes, error_mass,
                               interpret_pallas, scene_arrays)  # noqa: F401

W, H = 96, 80
FIELDS = ("means", "scales", "quats", "colors", "sh")
SP_FIELDS = ("mean2d", "radius", "color", "opacity", "depth")
# one compilation per configuration.  The JAX renders run eagerly: under
# jit XLA fuses the projection's products into FMAs, and a last-bit change
# of a 1/16-px ceiled support box flips whole fragments at its edge.
bin_j = jax.jit(surfel_j.bin_sort_surfels, static_argnums=(1,))


def _scene(n=600, seed=71, eye=(2.4, 1.5, 2.2), scale_mul=1.0):
    s_j, s_t = both_scenes(scene_arrays(n, sh_degree=1, seed=seed,
                                        scale_mul=scale_mul))
    cam_j, cam_t = both_cameras(gs.Camera.look_at(
        eye, (0, 0, 0), fov_y_deg=60, aspect=W / H))
    return s_j, s_t, cam_j, cam_t


def _scenes_args(n):
    """Three scenes: identity, a rotated and moved copy, a scaled one that
    is hidden; per-scene opacities.  (JAX arguments, port arguments)."""
    c, s = np.cos(0.4), np.sin(0.4)
    tfs = np.stack([np.eye(4),
                    [[c, 0, s, 0.3], [0, 1, 0, -0.2], [-s, 0, c, 0.1],
                     [0, 0, 0, 1]],
                    np.diag([1.5, 1.5, 1.5, 1.0])]).astype(np.float32)
    ids = (np.arange(n) % 3).astype(np.int32)
    ops = np.array([1.0, 0.7, 0.5], np.float32)
    vis = np.array([True, True, False])
    return ((jnp.asarray(tfs), jnp.asarray(ids), jnp.asarray(ops),
             jnp.asarray(vis)),
            (torch.tensor(tfs), torch.tensor(ids), torch.tensor(ops),
             torch.tensor(vis)))


def _cfgs(**kw):
    kw = dict(dict(width=W, height=H, sh_degree=1, render_mode_2d=True),
              **kw)
    return gs.RenderConfig(backend="pallas", **kw), gt.RenderConfig(**kw)


def _port_projection(sp_j):
    """The JAX package's SurfelProjection as the port's."""
    def t(a):
        return torch.from_numpy(np.array(a))
    return surfel_t.SurfelProjection(
        t=tuple(t(v) for v in sp_j.t),
        **{f: t(getattr(sp_j, f)) for f in SP_FIELDS}, mask=t(sp_j.mask))


def _window_slots(starts, counts):
    return np.concatenate([np.arange(s, s + c) for s, c in
                           zip(starts, counts)] + [np.zeros(0, np.int64)])


@pytest.mark.parametrize("scenes", [False, True])
def test_project_surfels_matches_jax(scenes):
    s_j, s_t, cam_j, cam_t = _scene()
    cfg_j, cfg_t = _cfgs()
    args_j, args_t = _scenes_args(600) if scenes else ((), ())
    sp_j = surfel_j.project_surfels(s_j, cam_j, cfg_j, *args_j)
    sp_t = surfel_t.project_surfels(s_t, cam_t, cfg_t, *args_t)
    mask = np.asarray(sp_j.mask)
    np.testing.assert_array_equal(sp_t.mask.numpy(), mask)
    assert 200 < mask.sum() <= (400 if scenes else 600)   # scene 3 hidden
    pairs = [(f"t{i}", a, b) for i, (a, b) in enumerate(zip(sp_t.t, sp_j.t))]
    pairs += [(f, getattr(sp_t, f), getattr(sp_j, f))
              for f in ("mean2d", "color", "opacity")]
    for name, a, b in pairs:
        a, b = a.numpy(), np.asarray(b)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), name
    d_t, d_j = sp_t.depth.numpy(), np.asarray(sp_j.depth)
    np.testing.assert_array_equal(np.isinf(d_t), ~mask)
    assert np.abs(d_t[mask] - d_j[mask]).max() <= 1e-5 * np.abs(
        d_j[mask]).max()
    dr = np.abs(sp_t.radius.numpy() - np.asarray(sp_j.radius))
    assert dr.max() <= 1.0 / 16.0 and np.mean(dr > 0) <= 5e-3


def test_project_surfels_gradients_match_jax():
    s_j, s_t, cam_j, cam_t = _scene(seed=72)
    cfg_j, cfg_t = _cfgs()
    rng = np.random.default_rng(73)
    wts = [rng.normal(size=600).astype(np.float32) for _ in range(9)]
    w2 = rng.normal(size=(600, 2)).astype(np.float32)
    w3 = rng.normal(size=(600, 3)).astype(np.float32)
    wo = rng.normal(size=600).astype(np.float32)

    def loss_j(s):
        sp = surfel_j.project_surfels(s, cam_j, cfg_j)
        return (sum(jnp.sum(t * w) for t, w in zip(sp.t, wts))
                + jnp.sum(sp.mean2d * w2) + jnp.sum(sp.color * w3)
                + jnp.sum(sp.opacity * wo))

    g_j = jax.jit(jax.grad(loss_j))(s_j)
    for f in FIELDS:
        getattr(s_t, f).requires_grad_(True)
    sp = surfel_t.project_surfels(s_t, cam_t, cfg_t)
    (sum((t * torch.from_numpy(w)).sum() for t, w in zip(sp.t, wts))
     + (sp.mean2d * torch.from_numpy(w2)).sum()
     + (sp.color * torch.from_numpy(w3)).sum()
     + (sp.opacity * torch.from_numpy(wo)).sum()).backward()
    for f in FIELDS:
        ref = np.asarray(getattr(g_j, f))
        scale = np.abs(ref).max()
        got = getattr(s_t, f).grad.numpy()
        assert scale > 0.0 and np.isfinite(got).all(), f
        assert error_mass(got / scale, ref / scale)[0] <= 1e-4, f


def _bin_both(sp_j, cfg_j, cfg_t):
    recs_j, st_j, ct_j, tot_j, ovf_j = bin_j(sp_j, cfg_j)
    rec_t, st_t, ct_t, tot_t, ovf_t = surfel_t.bin_sort_surfels(
        _port_projection(sp_j), cfg_t)
    starts, counts = np.asarray(st_j), np.asarray(ct_j)
    np.testing.assert_array_equal(st_t.numpy(), starts)
    np.testing.assert_array_equal(ct_t.numpy(), counts)
    assert int(tot_t) == int(tot_j) and int(ovf_t) == int(ovf_j)
    rec_j = np.asarray(recs_j).T
    assert rec_t.shape == rec_j.shape
    return rec_t, rec_j, _window_slots(starts, counts), int(ovf_j)


@pytest.mark.parametrize("kw", [
    dict(record_precision="f32"), dict(record_precision="f32",
                                       return_depth=True),
    dict(record_precision="mixed"), dict(record_precision="mixed",
                                         return_depth=True),
    dict(record_precision="packed"), dict(record_precision="packed",
                                          return_depth=True),
    dict(record_precision="mixed", forward_only=True),
    dict(record_precision="f32", zoom=True)],
    ids=["f32", "f32-depth", "mixed", "mixed-depth", "packed",
         "packed-depth", "forward_only", "overflow"])
def test_bin_sort_surfels_matches_jax_exactly(kw):
    zoom = kw.pop("zoom", False)
    if zoom:
        # big surfels over 48 tiles: their pairs exceed the aux capacity
        s_j, _ = both_scenes(scene_arrays(1000, sh_degree=1, seed=75,
                                          scale_mul=6.0))
        cam_j = gs.Camera.look_at((1.2, 0.7, 1.2), (0, 0, 0), fov_y_deg=60,
                                  aspect=256 / 192)
        kw.update(width=256, height=192)
    else:
        s_j, _, cam_j, _ = _scene(seed=74)
    cfg_j, cfg_t = _cfgs(**kw)
    sp_j = surfel_j.project_surfels(s_j, cam_j, cfg_j)
    rec_t, rec_j, slots, overflow = _bin_both(sp_j, cfg_j, cfg_t)
    assert slots.size > 500
    assert (overflow > 0) == zoom
    np.testing.assert_array_equal(rec_t.numpy()[:, slots].view(np.uint32),
                                  rec_j[:, slots].view(np.uint32))


@pytest.mark.parametrize("prec,depth", [("f32", True), ("mixed", False),
                                        ("packed", True)])
def test_bin_sort_surfels_gradients_match_jax(prec, depth):
    s_j, _, cam_j, _ = _scene(seed=76)
    cfg_j, cfg_t = _cfgs(record_precision=prec, return_depth=depth)
    sp_j = surfel_j.project_surfels(s_j, cam_j, cfg_j)
    _, rec_j, slots, _ = _bin_both(sp_j, cfg_j, cfg_t)
    nd = rec_j.shape[0] - 2                       # rx, ry carry none
    weights = np.random.default_rng(77).normal(
        size=(nd, slots.size)).astype(np.float32)
    names = ("t", "mean2d", "color", "opacity", "depth")

    def loss_j(*vals):
        recs = surfel_j.bin_sort_surfels(
            dataclasses.replace(sp_j, **dict(zip(names, vals))), cfg_j)[0]
        return jnp.sum(recs[slots, :nd].T * weights)

    g_j = jax.jit(jax.grad(loss_j, argnums=tuple(range(5))))(
        *(getattr(sp_j, f) for f in names))
    sp = _port_projection(sp_j)
    sp.t = tuple(t.requires_grad_(True) for t in sp.t)
    for f in names[1:]:
        getattr(sp, f).requires_grad_(True)
    rec = surfel_t.bin_sort_surfels(sp, cfg_t)[0]
    (rec[:nd, slots] * torch.from_numpy(weights)).sum().backward()
    got = [t.grad for t in sp.t] + [getattr(sp, f).grad for f in names[1:]]
    ref = [np.asarray(g) for g in list(g_j[0]) + list(g_j[1:])]
    bar = 1e-5 if prec == "f32" else 1e-2
    for i, (a, b) in enumerate(zip(got, ref)):
        scale = np.abs(b).max()
        if scale == 0.0:            # the depth without a depth channel
            assert i == 12 and not depth and a is None
            continue
        assert error_mass(a.numpy() / scale, b / scale)[0] <= bar, i


def _image_loss(out, depth):
    loss = (out["color"] ** 2).mean()
    return loss + (out["depth"] ** 2).mean() if depth else loss


@pytest.mark.parametrize("case", ["f32", "mixed-depth", "scenes"])
def test_render_2d_matches_jax(interpret_pallas, case):
    """render() in 2D against gs.render in 2D with the Pallas kernels in
    interpret mode, and (f32) the port's render_2d oracle against the JAX
    package's."""
    s_j, s_t, cam_j, cam_t = _scene(seed=78)
    cfg_j, cfg_t = _cfgs(record_precision="mixed" if case != "f32" else "f32",
                         return_depth=case == "mixed-depth",
                         background=(0.1, 0.2, 0.3))
    args_j, args_t = _scenes_args(600) if case == "scenes" else ((), ())
    out_j = gs.render(s_j, cam_j, cfg_j, *args_j, return_aux=True)
    out_t = gt.render(s_t, cam_t, cfg_t, *args_t, return_aux=True)
    keys = ("color", "alpha") + (("depth",) if case == "mixed-depth" else ())
    assert set(out_t) == set(keys) | {"num_pairs", "overflow"}
    assert int(out_t["num_pairs"]) == int(out_j["num_pairs"]) > 400
    assert int(out_t["overflow"]) == int(out_j["overflow"]) == 0
    for k in keys:
        a, b = out_t[k].numpy(), np.asarray(out_j[k])
        assert a.shape == b.shape and np.isfinite(a).all(), k
        p999, over = error_mass(a, b)
        assert p999 <= 1e-3 and over <= 1e-3, (k, p999, over)
    if case == "f32":
        o_t = surfel_t.render_2d(s_t, cam_t, cfg_t)
        o_j = surfel_j.render_2d(s_j, cam_j, cfg_j)
        for k in ("color", "alpha"):
            p999, over = error_mass(o_t[k].numpy(), np.asarray(o_j[k]))
            assert p999 <= 1e-3 and over <= 1e-3, k
            # the tiled path against its oracle
            assert error_mass(out_t[k].numpy(), o_t[k].numpy())[0] <= 1e-3


@pytest.mark.parametrize("prec", ["f32", "mixed"])
def test_render_2d_gradients_match_jax(interpret_pallas, prec):
    """d/d(every SplatData field) of mean(color^2) + mean(depth^2) over a
    background, against jax.grad of gs.render in 2D (Pallas, interpret):
    B4's glogt term carries the background's share."""
    s_j, s_t, cam_j, cam_t = _scene(n=300, seed=79)
    cfg_j, cfg_t = _cfgs(record_precision=prec, return_depth=True,
                         background=(0.5, 0.5, 0.5))
    g_j = jax.jit(jax.grad(lambda s: _image_loss(gs.render(s, cam_j, cfg_j),
                                                 True)))(s_j)
    for f in FIELDS:
        getattr(s_t, f).requires_grad_(True)
    _image_loss(gt.render(s_t, cam_t, cfg_t), True).backward()
    bar = 1e-3 if prec == "f32" else 1e-2
    assert float(s_t.scales.grad[:, 2].abs().max()) == 0.0
    for f in FIELDS:
        ref = np.asarray(getattr(g_j, f))
        got = getattr(s_t, f).grad.numpy()
        if f == "scales":
            ref, got = ref[:, :2], got[:, :2]
        scale = np.abs(ref).max()
        assert scale > 0.0 and np.isfinite(got).all(), f
        p999, _ = error_mass(got / scale, ref / scale)
        assert p999 <= bar, (f, p999)


def _tile_64_case(seed):
    """The tile-64 tests' scene and configurations: 300 splats over a
    background at 128 x 128, 2 x 2 tiles of 64, f32 records with depth."""
    s_j, s_t = both_scenes(scene_arrays(300, sh_degree=1, seed=seed))
    cam_j, cam_t = both_cameras(gs.Camera.look_at(
        (2.4, 1.5, 2.2), (0, 0, 0), fov_y_deg=60, aspect=1.0))
    cfg_j, cfg_t = _cfgs(width=128, height=128, tile_size=64,
                         record_precision="f32", return_depth=True,
                         background=(0.5, 0.5, 0.5))
    return s_j, s_t, cam_j, cam_t, cfg_j, cfg_t


def test_render_2d_matches_jax_at_tile_64(interpret_pallas):
    """render() in 2D at tile 64 (B3 as a cluster of four 32 x 32 blocks
    on a card; its plain version here) against gs.render in 2D with the
    Pallas kernels in interpret mode, under the images' bars."""
    s_j, s_t, cam_j, cam_t, cfg_j, cfg_t = _tile_64_case(seed=80)
    out_j = gs.render(s_j, cam_j, cfg_j, return_aux=True)
    out_t = gt.render(s_t, cam_t, cfg_t, return_aux=True)
    assert int(out_t["num_pairs"]) == int(out_j["num_pairs"]) > 200
    for k in ("color", "alpha", "depth"):
        a, b = out_t[k].numpy(), np.asarray(out_j[k])
        assert a.shape == b.shape and np.isfinite(a).all(), k
        p999, over = error_mass(a, b)
        assert p999 <= 1e-3 and over <= 1e-3, (k, p999, over)


def test_render_2d_gradients_match_jax_at_tile_64(interpret_pallas):
    """The 2D gradients of all five fields at tile 64 against jax.grad of
    gs.render in 2D (Pallas, interpret), under the f32 bar; scales[:, 2]
    gets none."""
    s_j, s_t, cam_j, cam_t, cfg_j, cfg_t = _tile_64_case(seed=81)
    g_j = jax.jit(jax.grad(lambda s: _image_loss(gs.render(s, cam_j, cfg_j),
                                                 True)))(s_j)
    for f in FIELDS:
        getattr(s_t, f).requires_grad_(True)
    _image_loss(gt.render(s_t, cam_t, cfg_t), True).backward()
    assert float(s_t.scales.grad[:, 2].abs().max()) == 0.0
    for f in FIELDS:
        ref = np.asarray(getattr(g_j, f))
        got = getattr(s_t, f).grad.numpy()
        if f == "scales":
            ref, got = ref[:, :2], got[:, :2]
        scale = np.abs(ref).max()
        assert scale > 0.0 and np.isfinite(got).all(), f
        p999, _ = error_mass(got / scale, ref / scale)
        assert p999 <= 1e-3, (f, p999)


def _tile_96_case(seed):
    """The tile-96 tests' scene and configurations: 300 splats over a
    background at 192 x 192, 2 x 2 tiles of 96 (on a card each walked by
    one block as 3 x 3 sub-tiles of 32 x 32), f32 records with depth; the
    JAX package's backend="jax" (its XLA surfel compositor)."""
    s_j, s_t = both_scenes(scene_arrays(300, sh_degree=1, seed=seed))
    cam_j, cam_t = both_cameras(gs.Camera.look_at(
        (2.4, 1.5, 2.2), (0, 0, 0), fov_y_deg=60, aspect=1.0))
    kw = dict(width=192, height=192, sh_degree=1, render_mode_2d=True,
              tile_size=96, record_precision="f32", return_depth=True,
              background=(0.5, 0.5, 0.5))
    return (s_j, s_t, cam_j, cam_t, gs.RenderConfig(backend="jax", **kw),
            gt.RenderConfig(**kw))


def test_render_2d_matches_jax_at_tile_96():
    """render() in 2D at tile 96 (B3 walking 32 x 32 sub-tiles on a card;
    its plain version here) against gs.render in 2D with backend="jax",
    under the images' bars."""
    s_j, s_t, cam_j, cam_t, cfg_j, cfg_t = _tile_96_case(seed=82)
    out_j = gs.render(s_j, cam_j, cfg_j, return_aux=True)
    out_t = gt.render(s_t, cam_t, cfg_t, return_aux=True)
    assert int(out_t["num_pairs"]) == int(out_j["num_pairs"]) > 200
    for k in ("color", "alpha", "depth"):
        a, b = out_t[k].numpy(), np.asarray(out_j[k])
        assert a.shape == b.shape and np.isfinite(a).all(), k
        p999, over = error_mass(a, b)
        assert p999 <= 1e-3 and over <= 1e-3, (k, p999, over)


def test_render_2d_gradients_match_jax_at_tile_96():
    """The 2D gradients of all five fields at tile 96 against jax.grad of
    gs.render in 2D with backend="jax", under the f32 bar; scales[:, 2]
    gets none.  jax.grad runs eagerly, as the renders do: under jit a
    fused FMA flips a 1/16-px box edge of this scene."""
    s_j, s_t, cam_j, cam_t, cfg_j, cfg_t = _tile_96_case(seed=83)
    g_j = jax.grad(lambda s: _image_loss(gs.render(s, cam_j, cfg_j),
                                         True))(s_j)
    for f in FIELDS:
        getattr(s_t, f).requires_grad_(True)
    _image_loss(gt.render(s_t, cam_t, cfg_t), True).backward()
    assert float(s_t.scales.grad[:, 2].abs().max()) == 0.0
    for f in FIELDS:
        ref = np.asarray(getattr(g_j, f))
        got = getattr(s_t, f).grad.numpy()
        if f == "scales":
            ref, got = ref[:, :2], got[:, :2]
        scale = np.abs(ref).max()
        assert scale > 0.0 and np.isfinite(got).all(), f
        p999, _ = error_mass(got / scale, ref / scale)
        assert p999 <= 1e-3, (f, p999)


def test_train_step_2d_matches_jax():
    """make_train_step with render_mode_2d trains surfels: its loss is the
    JAX package's 2D step's, not the 3D step's, scales[:, 2] gets no
    gradient, and 3 Adam steps agree with the JAX step's."""
    s_j, s_t = both_scenes(scene_arrays(200, sh_degree=1, seed=51))
    cam_j, cam_t = both_cameras(gs.Camera.look_at((2.2, 1.4, 2.0),
                                                  (0, 0, 0)))
    kw = dict(width=64, height=64, sh_degree=1, sort_bits=16,
              record_precision="f32", render_mode_2d=True)
    cfg_j, cfg_t = gs.RenderConfig(**kw), gt.RenderConfig(**kw)
    target = np.random.default_rng(52).uniform(
        0.0, 1.0, (64, 64, 3)).astype(np.float32)
    lr = 1e-2
    opt = optax.adam(lr)
    state_j = train_j.TrainState.create(s_j, opt)
    step_j = jax.jit(train_j.make_train_step(
        cfg_j, make_mesh(jax.devices()[:1], 1, 1), opt))
    tiles_j, mask_j = train_j.image_to_tile_blocks(jnp.asarray(target), cfg_j)
    tiles_t, mask_t = train_t.image_to_tile_blocks(torch.tensor(target),
                                                   cfg_t)
    # the 3D step on the same scene: a different loss
    state_3d = train_t.TrainState.create(s_t, train_t.adam(lr))
    _, m_3d = train_t.make_train_step(cfg_t.replace(render_mode_2d=False),
                                      None, train_t.adam(lr))(
        state_3d, cam_t, tiles_t, mask_t)
    state_t = train_t.TrainState.create(s_t, train_t.adam(lr))
    step_t = train_t.make_train_step(cfg_t, None, train_t.adam(lr))
    for i in range(3):
        state_j, m_j = step_j(state_j, cam_j, tiles_j, mask_j)
        state_t, m_t = step_t(state_t, cam_t, tiles_t, mask_t)
        np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m_t["grad_norm"]),
                                   float(m_j["grad_norm"]), rtol=1e-3)
        if i == 0:
            assert abs(float(m_3d["loss"]) / float(m_t["loss"]) - 1) > 1e-2
            assert float(state_t.params.log_scales.grad[:, 2].abs().max()
                         ) == 0.0
    names = train_t.SplatParams.FIELDS
    for f in names:
        a = getattr(state_t.params, f).detach().numpy()
        b = np.asarray(getattr(state_j.params, f))
        d = np.abs(a - b).ravel() / (3 * lr)
        assert np.quantile(d, 0.99) <= 2e-2, (f, np.quantile(d, 0.99))
        assert d.max() <= 1.0, f


def test_render_tiles_routes_on_the_mode():
    """pipeline.render_tiles is the one place that picks the 3D or the
    surfel route: render() assembles its tile blocks in both modes, the
    two modes give different blocks, and render_2d_tiled renders surfels
    whatever cfg.render_mode_2d says."""
    _, s_t, _, cam_t = _scene(n=200, seed=81)
    _, cfg = _cfgs(return_depth=True, background=(0.1, 0.2, 0.3))
    chans = {}
    for mode_2d in (True, False):
        c = cfg.replace(render_mode_2d=mode_2d)
        chans[mode_2d], num_pairs, overflow = pipe_t.render_tiles(s_t, cam_t,
                                                                  c)
        assert chans[mode_2d].shape == (c.num_tiles, 5, c.tile_size ** 2)
        out = gt.render(s_t, cam_t, c, return_aux=True)
        img = pipe_t.assemble_image(chans[mode_2d], c)
        for k in ("color", "alpha", "depth"):
            assert torch.equal(out[k], img[k]), (mode_2d, k)
        assert int(out["num_pairs"]) == int(num_pairs) > 0
        assert int(out["overflow"]) == int(overflow) == 0
    assert float((chans[True] - chans[False]).abs().max()) > 1e-2
    flat = pipe_t.render_2d_tiled(s_t, cam_t,
                                  cfg.replace(render_mode_2d=False),
                                  return_aux=True)
    ref = gt.render(s_t, cam_t, cfg, return_aux=True)
    assert set(flat) == set(ref)
    for k in ref:
        assert torch.equal(flat[k], ref[k]), k


def test_render_batch_2d_and_unported_arguments():
    """render_batch follows render() into 2D; the multi-GPU arguments of
    the surfel binning and compositor raise."""
    _, s_t, _, cam_t = _scene(n=200, seed=80)
    _, cfg = _cfgs()
    away = gt.Camera.look_at((2.4, 1.5, 2.2), (5.0, 3.0, 5.0),
                             aspect=W / H, device="cpu")
    outs = pipe_t.render_batch(s_t, pipe_t.stack_cameras([cam_t, away]), cfg)
    assert outs["color"].shape == (2, H, W, 3)
    assert torch.equal(outs["color"][0], gt.render(s_t, cam_t, cfg)["color"])
    assert float(outs["alpha"][0].max()) > 0.5
    assert float(outs["alpha"][1].abs().max()) == 0.0
    # the multi-GPU slab arguments bin and composite a slab
    # (tests/test_torch_sharded.py holds them to the JAX package's)
    sp = surfel_t.project_surfels(s_t, cam_t, cfg)
    tx = cfg.tiles_x
    for kw in (dict(tile_range=(0, tx)), dict(depth_bounds=(0.0, 1.0)),
               dict(row_window=(0, 2, 1)), dict(aux_capacity=4096)):
        starts = surfel_t.bin_sort_surfels(sp, cfg, **kw)[1]
        assert starts.shape == ((tx,) if {"tile_range", "row_window"}
                                & set(kw) else (cfg.num_tiles,))
    with pytest.raises(ValueError):
        surfel_t.bin_sort_surfels(sp, cfg, tile_range=(1, tx))
    recs, starts, counts, _, _ = surfel_t.bin_sort_surfels(
        sp, cfg, tile_range=(tx, tx))
    colors, _ = surfel_t.composite_surfels_sorted(cfg, recs, starts, counts,
                                                  tx, tx)
    assert colors.shape[0] == tx
    recs, starts, counts, _, _ = surfel_t.bin_sort_surfels(sp, cfg)
    with pytest.raises(ValueError):
        surfel_t.composite_surfels_sorted(cfg.replace(return_depth=True),
                                          recs, starts, counts, 0,
                                          cfg.num_tiles)
    with pytest.raises(ValueError):
        gt.render(s_t, cam_t, cfg.replace(backend="cuda"))
