"""The port's render, end to end (render/pipeline.py), against the JAX
package's gs.render(backend="jax") and gs.reference_render, on the same
numpy-made scene and camera: the images, and the gradients of an image
loss with respect to all five SplatData fields.

Bars, by error mass (the hard thresholds flip on last-ulp differences, so
never the elementwise max): images p99.9 of |d| <= 1e-3 and <= 0.1% of
pixels over 1e-2, for color, alpha and (where asked) depth.  Gradients,
per field, |d| normalised by the field's max |JAX|: p99.9 <= 1e-2
(test_pallas.py:124's bar; the port's B2 replays an early exit that
backend="jax" does not have), under every record precision: the JAX
package's bf16 rounding of the non-position cotangents under mixed and
packed (a relative 2^-9 per pair) stays well inside it."""

import jax
import numpy as np
import pytest
import torch

import gaussiansplats3d_tpu as gs
import gaussiansplats3d_tpu_torch as gt
from gaussiansplats3d_tpu_torch.render import cuda_rasterize as cr
from gaussiansplats3d_tpu_torch.render import pipeline as pipe_t
from gaussiansplats3d_tpu_torch.utils import metrics

from torch_port_common import (both_cameras, both_scenes, cuda_device,  # noqa: F401
                               error_mass, interpret_pallas, scene_arrays)

W = H = 96
KEYS = ("color", "alpha")
FIELDS = ("means", "scales", "quats", "colors", "sh")
# one compilation per configuration instead of op-by-op dispatch
render_j = jax.jit(gs.render, static_argnums=(2,),
                   static_argnames=("return_aux",))


def _image_loss(out, depth):
    loss = (out["color"] ** 2).mean()
    return loss + (out["depth"] ** 2).mean() if depth else loss


def _scene(seed=41, n=800, sh_degree=1):
    s_j, s_t = both_scenes(scene_arrays(n, sh_degree=sh_degree, seed=seed))
    cam_j, cam_t = both_cameras(gs.Camera.look_at(
        (2.5, 1.5, 2.5), (0, 0, 0), fov_y_deg=60, aspect=W / H))
    return s_j, s_t, cam_j, cam_t


def _assert_close(out_t, out_j, keys):
    for k in keys:
        a = out_t[k].detach().cpu().numpy()
        b = np.asarray(out_j[k])
        assert a.shape == b.shape, k
        assert np.isfinite(a).all(), k
        p999, over = error_mass(a, b)
        assert p999 <= 1e-3 and over <= 1e-3, (k, p999, over)


@pytest.mark.parametrize("prec", ["mixed", "f32"])
@pytest.mark.parametrize("depth", [False, True])
def test_render_matches_jax(prec, depth):
    s_j, s_t, cam_j, cam_t = _scene()
    kw = dict(width=W, height=H, sh_degree=1, record_precision=prec,
              return_depth=depth, background=(0.2, 0.1, 0.3))
    out_j = render_j(s_j, cam_j, gs.RenderConfig(backend="jax", **kw),
                     return_aux=True)
    out_t = gt.render(s_t, cam_t, gt.RenderConfig(**kw), return_aux=True)
    keys = KEYS + (("depth",) if depth else ())
    _assert_close(out_t, out_j, keys)
    assert int(out_t["num_pairs"]) == int(out_j["num_pairs"]) > 0
    assert int(out_t["overflow"]) == int(out_j["overflow"])
    if prec == "f32" and not depth:
        ref_j = gs.reference_render(s_j, cam_j, gs.RenderConfig(**kw))
        _assert_close(out_t, ref_j, KEYS)
        _assert_close(gt.reference_render(s_t, cam_t, gt.RenderConfig(**kw)),
                      ref_j, KEYS)


def test_render_packed_forward_only_matches_jax():
    s_j, s_t, cam_j, cam_t = _scene(seed=42)
    kw = dict(width=W, height=H, sh_degree=1, record_precision="packed",
              forward_only=True)
    out_j = render_j(s_j, cam_j, gs.RenderConfig(backend="jax", **kw))
    out_t = gt.render(s_t, cam_t, gt.RenderConfig(**kw))
    _assert_close(out_t, out_j, KEYS)


def test_render_batch_assembly_and_errors():
    _, s_t, cam_j, cam_t = _scene(seed=43, n=300, sh_degree=0)
    cfg = gt.RenderConfig(width=W, height=H, background=(1.0, 1.0, 1.0))
    away = gt.Camera.look_at((2.5, 1.5, 2.5), (5.0, 3.0, 5.0), aspect=1.0,
                             device="cpu")
    outs = pipe_t.render_batch(s_t, pipe_t.stack_cameras([cam_t, away]), cfg)
    assert outs["color"].shape == (2, H, W, 3)
    single = gt.render(s_t, cam_t, cfg)
    assert torch.equal(outs["color"][0], single["color"])
    # a camera facing away sees only the background
    assert torch.equal(outs["color"][1], torch.ones(H, W, 3))
    assert float(outs["alpha"][1].abs().max()) == 0.0
    before = (metrics.total(cr.LAUNCHES), metrics.total(cr.BWD_LAUNCHES))
    with pytest.raises(ValueError):
        gt.render(s_t, cam_t, cfg.replace(backend="cuda"))
    s_t.means.requires_grad_(True)
    img = gt.render(s_t, cam_t, cfg)["color"]
    img.sum().backward()                   # the plain B2 on the CPU
    assert bool(torch.isfinite(s_t.means.grad).all())
    assert float(s_t.means.grad.abs().max()) > 0.0
    # the CPU path never launches a kernel
    assert (metrics.total(cr.LAUNCHES),
            metrics.total(cr.BWD_LAUNCHES)) == before


@pytest.mark.parametrize("backend,prec,depth", [
    ("jax", "f32", False), ("jax", "f32", True), ("jax", "mixed", False),
    ("jax", "packed", False), ("pallas", "f32", False)])
def test_render_gradients_match_jax(request, backend, prec, depth):
    """d/d(every SplatData field) of mean(color^2) (+ mean(depth^2)),
    against jax.grad of the JAX render; "pallas" runs the Pallas kernels in
    interpret mode, at a smaller size."""
    n, size = (300, 64) if backend == "pallas" else (800, W)
    if backend == "pallas":
        request.getfixturevalue("interpret_pallas")
    _assert_gradients_match_jax(n, dict(
        width=size, height=size, sh_degree=1, record_precision=prec,
        return_depth=depth), backend, depth)


def test_render_gradients_match_jax_at_tile_12():
    """The same at tile size 12, whose 144 pixels are no whole number of
    warps and whose 8 x 8 warp patches are cut at the tile's edge: the
    plain B2 on the CPU, against jax.grad of backend="jax", under the same
    bar (the size a CUDA device's B2 now accepts too)."""
    _assert_gradients_match_jax(800, dict(
        width=W, height=H, tile_size=12, sh_degree=1,
        record_precision="f32"), "jax", False)


# The tile-64 tests' scene: 600 splats at 128 x 128, 2 x 2 tiles of 64 (4
# x 4 tiles of 40, cut at the image's edge, at side 40).
T64_SIZE, T64_SPLATS = 128, 600


@pytest.mark.parametrize("prec", ["mixed", "f32"])
@pytest.mark.parametrize("tile", [64, 40])
def test_render_matches_jax_at_tile_64(tile, prec):
    """render() at tile 64 (the CUDA compositors' cluster of four 32 x 32
    blocks; the plain versions here) and at side 40 (quadrants 32 and 8
    wide) against gs.render(backend="jax"), under the images' bars, with
    the same pair count."""
    s_j, s_t, cam_j, cam_t = _scene(seed=48, n=T64_SPLATS)
    kw = dict(width=T64_SIZE, height=T64_SIZE, tile_size=tile, sh_degree=1,
              record_precision=prec, background=(0.2, 0.1, 0.3))
    out_j = render_j(s_j, cam_j, gs.RenderConfig(backend="jax", **kw),
                     return_aux=True)
    out_t = gt.render(s_t, cam_t, gt.RenderConfig(**kw), return_aux=True)
    _assert_close(out_t, out_j, KEYS)
    assert int(out_t["num_pairs"]) == int(out_j["num_pairs"]) > 0
    assert int(out_t["overflow"]) == int(out_j["overflow"]) == 0


def test_render_gradients_match_jax_at_tile_64():
    """The gradients of all five fields at tile 64, the plain B2 on the
    CPU against jax.grad of backend="jax", under the same bar."""
    _assert_gradients_match_jax(T64_SPLATS, dict(
        width=T64_SIZE, height=T64_SIZE, tile_size=64, sh_degree=1,
        record_precision="f32"), "jax", False)


# The tile-96 tests' scene: 800 splats at 192 x 192, 2 x 2 tiles of 96,
# each walked by the CUDA compositors as 3 x 3 sub-tiles of 32 x 32.
T96_SIZE, T96_SPLATS = 192, 800


def test_render_matches_jax_at_tile_96():
    """render() at tile 96 (on a card one block a tile walking its 32 x 32
    sub-tiles; the plain versions here) against gs.render(backend="jax"),
    f32 records, under the images' bars, with the same pair count."""
    s_j, s_t, cam_j, cam_t = _scene(seed=50, n=T96_SPLATS)
    kw = dict(width=T96_SIZE, height=T96_SIZE, tile_size=96, sh_degree=1,
              record_precision="f32", background=(0.2, 0.1, 0.3))
    out_j = render_j(s_j, cam_j, gs.RenderConfig(backend="jax", **kw),
                     return_aux=True)
    out_t = gt.render(s_t, cam_t, gt.RenderConfig(**kw), return_aux=True)
    _assert_close(out_t, out_j, KEYS)
    assert int(out_t["num_pairs"]) == int(out_j["num_pairs"]) > 0
    assert int(out_t["overflow"]) == int(out_j["overflow"]) == 0


def test_render_gradients_match_jax_at_tile_96():
    """The gradients of all five fields at tile 96, the plain B2 on the
    CPU against jax.grad of backend="jax", under the same bar."""
    _assert_gradients_match_jax(T96_SPLATS, dict(
        width=T96_SIZE, height=T96_SIZE, tile_size=96, sh_degree=1,
        record_precision="f32"), "jax", False)


def _assert_gradients_match_jax(n, kw, backend, depth):
    s_j, _ = both_scenes(scene_arrays(n, sh_degree=1, seed=45))
    cam_j, cam_t = both_cameras(gs.Camera.look_at(
        (2.5, 1.5, 2.5), (0, 0, 0), fov_y_deg=60, aspect=1.0))
    cfg_j = gs.RenderConfig(backend=backend, **kw)
    g_j = jax.jit(jax.grad(lambda s: _image_loss(gs.render(s, cam_j, cfg_j),
                                                 depth)))(s_j)
    s_t = gt.SplatData.from_numpy(*scene_arrays(n, sh_degree=1, seed=45),
                                  device="cpu")
    for f in FIELDS:
        getattr(s_t, f).requires_grad_(True)
    _image_loss(gt.render(s_t, cam_t, gt.RenderConfig(**kw)),
                depth).backward()
    for f in FIELDS:
        ref = np.asarray(getattr(g_j, f))
        scale = np.abs(ref).max()
        assert scale > 0.0, f
        got = getattr(s_t, f).grad.numpy()
        assert np.isfinite(got).all(), f
        p999, _ = error_mass(got / scale, ref / scale)
        assert p999 <= 1e-2, (f, p999)


@pytest.mark.cuda
def test_cuda_render_gradients_match_cpu(cuda_device):
    """A backward through render() on the card launches B1 and B2 once
    each and gives the CPU render's gradients."""
    _assert_cuda_gradients_match_cpu(cuda_device, gt.RenderConfig(
        width=256, height=192, sh_degree=1, record_precision="f32",
        return_depth=True))


@pytest.mark.cuda
def test_cuda_render_gradients_match_cpu_at_tile_12(cuda_device):
    """The same training step at tile size 12 (warp patches cut at the
    tile's edge), which B2 once refused on the card."""
    _assert_cuda_gradients_match_cpu(cuda_device, gt.RenderConfig(
        width=256, height=192, tile_size=12, sh_degree=1,
        record_precision="f32", return_depth=True))


@pytest.mark.cuda
def test_cuda_render_gradients_match_cpu_at_tile_64(cuda_device):
    """The same training step at tile size 64: B1 and B2 as clusters of
    four 32 x 32 blocks, once each."""
    _assert_cuda_gradients_match_cpu(cuda_device, gt.RenderConfig(
        width=256, height=192, tile_size=64, sh_degree=1,
        record_precision="f32", return_depth=True))


@pytest.mark.cuda
def test_cuda_render_gradients_match_cpu_at_tile_128(cuda_device):
    """The same training step at tile size 128: B1 and B2 as one block a
    tile walking its 4 x 4 sub-tiles of 32 x 32, once each."""
    _assert_cuda_gradients_match_cpu(cuda_device, gt.RenderConfig(
        width=256, height=192, tile_size=128, sh_degree=1,
        record_precision="f32", return_depth=True))


@pytest.mark.cuda
def test_cuda_side_65_matches_cpu_render(cuda_device):
    """A side of 65 (one block walking 3 x 3 sub-tiles, 1 px wide at the
    tile's edge): render() on the card launches B1 once and gives the CPU
    render's images."""
    arrays = scene_arrays(2000, sh_degree=1, seed=49)
    cam_j = gs.Camera.look_at((2.5, 1.5, 2.5), (0, 0, 0), fov_y_deg=60,
                              aspect=4 / 3)
    cfg = gt.RenderConfig(width=160, height=120, tile_size=65, sh_degree=1,
                          return_depth=True)
    outs = []
    for dev in ("cpu", cuda_device):
        s = gt.SplatData.from_numpy(*arrays, device=dev)
        cam = gt.Camera.from_numpy(np.asarray(cam_j.view),
                                   np.asarray(cam_j.proj),
                                   np.asarray(cam_j.cam_pos), device=dev)
        before = (metrics.total(cr.LAUNCHES), metrics.total(cr.BWD_LAUNCHES))
        outs.append(gt.render(s, cam, cfg, return_aux=True))
        expect = 1 if dev != "cpu" else 0
        assert (metrics.total(cr.LAUNCHES),
                metrics.total(cr.BWD_LAUNCHES)) == (before[0] + expect,
                                                    before[1])
    assert int(outs[1]["num_pairs"]) == int(outs[0]["num_pairs"]) > 0
    assert float(outs[0]["alpha"].max()) > 0.0
    _assert_close(outs[1], {k: v.numpy() for k, v in outs[0].items()},
                  KEYS + ("depth",))


def _assert_cuda_gradients_match_cpu(cuda_device, cfg):
    arrays = scene_arrays(3000, sh_degree=1, seed=46)
    cam_j = gs.Camera.look_at((2.5, 1.5, 2.5), (0, 0, 0), fov_y_deg=60,
                              aspect=4 / 3)
    grads = []
    for dev in ("cpu", cuda_device):
        s = gt.SplatData.from_numpy(*arrays, device=dev)
        for f in FIELDS:
            getattr(s, f).requires_grad_(True)
        cam = gt.Camera.from_numpy(np.asarray(cam_j.view),
                                   np.asarray(cam_j.proj),
                                   np.asarray(cam_j.cam_pos), device=dev)
        before = (metrics.total(cr.LAUNCHES), metrics.total(cr.BWD_LAUNCHES))
        _image_loss(gt.render(s, cam, cfg), True).backward()
        after = (metrics.total(cr.LAUNCHES), metrics.total(cr.BWD_LAUNCHES))
        expect = 1 if dev != "cpu" else 0
        assert after == (before[0] + expect, before[1] + expect)
        grads.append({f: getattr(s, f).grad.cpu().numpy() for f in FIELDS})
    for f in FIELDS:
        scale = np.abs(grads[0][f]).max()
        p999, over = error_mass(grads[1][f] / scale, grads[0][f] / scale)
        assert p999 <= 1e-3 and over <= 1e-3, (f, p999, over)


@pytest.mark.cuda
def test_cuda_render_matches_cpu_render(cuda_device):
    arrays = scene_arrays(4000, sh_degree=1, seed=44)
    cam_j = gs.Camera.look_at((2.5, 1.5, 2.5), (0, 0, 0), fov_y_deg=60,
                              aspect=4 / 3)
    outs = []
    before = metrics.total(cr.LAUNCHES)
    for dev in ("cpu", cuda_device):
        s = gt.SplatData.from_numpy(*arrays, device=dev)
        cam = gt.Camera.from_numpy(np.asarray(cam_j.view),
                                   np.asarray(cam_j.proj),
                                   np.asarray(cam_j.cam_pos), device=dev)
        outs.append(gt.render(s, cam, gt.RenderConfig(
            width=256, height=192, sh_degree=1, return_depth=True)))
    # the CUDA render ran kernel B1
    assert metrics.total(cr.LAUNCHES) == before + 1
    _assert_close(outs[1], {k: v.numpy() for k, v in outs[0].items()},
                  KEYS + ("depth",))
