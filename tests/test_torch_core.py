"""Port core (gaussiansplats3d_tpu_torch.core) against the JAX package:
SH evaluation, covariance and camera matrices on shared numpy inputs.
Bar: 1e-5 relative (float32 elementwise math in the same order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussiansplats3d_tpu as gs
import gaussiansplats3d_tpu_torch as gt
from gaussiansplats3d_tpu.core import covariance as cov_j
from gaussiansplats3d_tpu.core import math3d as m3_j
from gaussiansplats3d_tpu.core import sh as sh_j
from gaussiansplats3d_tpu.core.types import derive_focal as focal_j
from gaussiansplats3d_tpu_torch.core import covariance as cov_t
from gaussiansplats3d_tpu_torch.core import math3d as m3_t
from gaussiansplats3d_tpu_torch.core import sh as sh_t
from gaussiansplats3d_tpu_torch.core.types import derive_focal as focal_t

from torch_port_common import scene_arrays

RTOL = 1e-5


def close(t, j, rtol=RTOL, atol=1e-7):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j),
                               rtol=rtol, atol=atol)


def close_scaled(t, j):
    """1e-5 relative to the array's scale: off-diagonal covariance entries
    are sums that cancel, so their own relative error is unbounded."""
    j = np.asarray(j)
    close(t, j, atol=RTOL * float(np.abs(j).max()))


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_eval_matches_jax(degree):
    means, _, _, colors, sh = scene_arrays(500, sh_degree=3, seed=degree)
    dirs = means / np.linalg.norm(means, axis=1, keepdims=True)
    out_t = sh_t.eval_sh_color(torch.from_numpy(colors[:, :3]),
                               torch.from_numpy(sh), torch.from_numpy(dirs),
                               degree)
    out_j = sh_j.eval_sh_color(jnp.asarray(colors[:, :3]), jnp.asarray(sh),
                               jnp.asarray(dirs), degree)
    close(out_t, out_j)


def test_covariance_and_quadratic_form_match_jax():
    _, scales, quats, _, _ = scene_arrays(500, seed=3, scale_mul=20.0)
    quats = quats * 1.7          # unnormalised: both normalise internally
    c6_t = cov_t.covariance6_elements(torch.from_numpy(scales),
                                      torch.from_numpy(quats))
    c6_j = cov_j.covariance6_elements(jnp.asarray(scales), jnp.asarray(quats))
    for a, b in zip(c6_t, c6_j):
        close_scaled(a, b)
    rng = np.random.default_rng(4)
    u, v = (rng.normal(size=(3, 500)).astype(np.float32) for _ in range(2))
    q_t = cov_t.quadratic_form6(c6_t, tuple(torch.from_numpy(r) for r in u),
                                tuple(torch.from_numpy(r) for r in v))
    q_j = cov_j.quadratic_form6(c6_j, tuple(jnp.asarray(r) for r in u),
                                tuple(jnp.asarray(r) for r in v))
    close_scaled(q_t, q_j)
    # the full covariance, from the rotation matrix
    r = m3_t.quat_to_rotmat(torch.from_numpy(quats)).numpy()
    full = np.einsum("nij,nj,nkj->nik", r, scales.astype(np.float64) ** 2, r)
    np.testing.assert_allclose(c6_t[1].numpy(), full[:, 0, 1], atol=1e-6)
    close(m3_t.quat_to_rotmat(torch.from_numpy(quats)),
          m3_j.quat_to_rotmat(jnp.asarray(quats)), atol=1e-6)


@pytest.mark.parametrize("with_transform", [False, True])
def test_full_covariance_and_covariance6_match_jax(with_transform):
    """covariance_from_scale_quat ([N, 3, 3]) and covariance6 ([N, 6]),
    with and without a scene transform applied congruently, against the
    JAX functions at 1e-6."""
    _, scales, quats, _, _ = scene_arrays(500, seed=6, scale_mul=10.0)
    quats = quats * 1.7          # unnormalised: both normalise internally
    t3 = (np.random.default_rng(6).uniform(-1.0, 1.0, (3, 3))
          .astype(np.float32) if with_transform else None)
    args_t = [torch.from_numpy(scales), torch.from_numpy(quats),
              None if t3 is None else torch.from_numpy(t3)]
    args_j = [jnp.asarray(scales), jnp.asarray(quats),
              None if t3 is None else jnp.asarray(t3)]
    full_t = cov_t.covariance_from_scale_quat(*args_t)
    assert full_t.shape == (500, 3, 3)
    close(full_t, cov_j.covariance_from_scale_quat(*args_j), rtol=0,
          atol=1e-6)
    c6_t = cov_t.covariance6(*args_t)
    assert c6_t.shape == (500, 6)
    close(c6_t, cov_j.covariance6(*args_j), rtol=0, atol=1e-6)
    if t3 is None:                 # the flat entries' order is (xx .. zz)
        close_scaled(c6_t.T, jnp.stack(cov_j.covariance6_elements(
            *args_j[:2])))


def test_covariance_isotropy_congruence_and_axis_order():
    """tests/test_core_math.py's cases on the port: an isotropic scale
    gives s^2 I under any rotation, a transform diag(2, 1, 1) scales it
    congruently, and covariance6 packs (xx, xy, xz, yy, yz, zz)."""
    quats = m3_t.normalize(torch.from_numpy(
        np.random.default_rng(3).normal(size=(8, 4)).astype(np.float32)))
    scales = torch.full((8, 3), 0.5)
    close(cov_t.covariance_from_scale_quat(scales, quats),
          np.tile(0.25 * np.eye(3), (8, 1, 1)), rtol=0, atol=1e-5)
    t3 = torch.tensor([[2.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]])
    close(cov_t.covariance_from_scale_quat(scales, quats, t3),
          np.tile(np.diag([1.0, 0.25, 0.25]), (8, 1, 1)), rtol=0, atol=1e-5)
    c6 = cov_t.covariance6(torch.tensor([[1.0, 2.0, 3.0]]),
                           torch.tensor([[0.0, 0.0, 0.0, 1.0]]))
    close(c6[0], [1.0, 0.0, 0.0, 4.0, 0.0, 9.0], rtol=0, atol=1e-6)


def test_composite_chunk_matches_jax():
    """One chunk of 64 front-to-back splats over 256 pixels, four
    channels, onto a running color and transmittance: the port's
    composite_chunk against the JAX one at 1e-5."""
    from gaussiansplats3d_tpu.render import compositing as comp_j
    from gaussiansplats3d_tpu_torch.render import compositing as comp_t
    rng = np.random.default_rng(8)
    c, p = 64, 256
    px = rng.uniform(0.0, 16.0, p).astype(np.float32)
    py = rng.uniform(0.0, 16.0, p).astype(np.float32)
    mean2d = rng.uniform(0.0, 16.0, (c, 2)).astype(np.float32)
    a, cc = rng.uniform(0.05, 0.6, (2, c))
    b = rng.uniform(-0.5, 0.5, c) * np.sqrt(a * cc)
    conic = np.stack([a, b, cc], axis=1).astype(np.float32)
    color = rng.uniform(0.0, 1.0, (c, 4)).astype(np.float32)
    opacity = rng.uniform(0.1, 1.0, c).astype(np.float32)
    radius = rng.uniform(1.0, 8.0, (c, 2)).astype(np.float32)
    acc = rng.uniform(0.0, 0.5, (p, 4)).astype(np.float32)
    trans = rng.uniform(0.2, 1.0, p).astype(np.float32)
    args = (px, py, mean2d, conic, color, opacity, radius)
    out_t = comp_t.composite_chunk(*map(torch.from_numpy, args), 1 / 255,
                                   torch.from_numpy(acc),
                                   torch.from_numpy(trans))
    out_j = comp_j.composite_chunk(*map(jnp.asarray, args), 1 / 255,
                                   jnp.asarray(acc), jnp.asarray(trans))
    for t, j in zip(out_t, out_j):
        close(t, j, rtol=0, atol=1e-5)
    assert float(torch.max(torch.from_numpy(trans) - out_t[1])) > 0.1


@pytest.mark.parametrize("eye,target,up", [
    ((2.5, 1.5, 2.5), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)),
    ((-1.0, 4.0, 0.3), (0.2, -0.1, 0.5), (0.0, 0.0, 1.0)),
])
def test_camera_matrices_match_jax(eye, target, up):
    view_t = m3_t.look_at_view_matrix(eye, target, up, device="cpu")
    close(view_t, m3_j.look_at_view_matrix(eye, target, up), atol=1e-6)
    for fov, aspect in ((60.0, 16 / 9), (35.0, 1.0)):
        close(m3_t.perspective_projection(fov, aspect, 0.1, 500.0,
                                          device="cpu"),
              m3_j.perspective_projection(fov, aspect, 0.1, 500.0))
    close(m3_t.orthographic_projection(-2.0, 1.5, -1.0, 1.2, 0.1, 50.0,
                                       device="cpu"),
          m3_j.orthographic_projection(-2.0, 1.5, -1.0, 1.2, 0.1, 50.0))
    cam_t = gt.Camera.look_at(eye, target, up, fov_y_deg=50.0, aspect=1.5,
                              device="cpu")
    cam_j = gs.Camera.look_at(eye, target, up, fov_y_deg=50.0, aspect=1.5)
    for a, b in ((cam_t.view, cam_j.view), (cam_t.proj, cam_j.proj),
                 (cam_t.cam_pos, cam_j.cam_pos)):
        close(a, b, atol=1e-6)
    ortho_t = gt.Camera.orthographic(eye, target, up, half_height=1.3,
                                     aspect=2.0, device="cpu")
    ortho_j = gs.Camera.orthographic(eye, target, up, half_height=1.3,
                                     aspect=2.0)
    close(ortho_t.proj, ortho_j.proj)
    close(focal_t(cam_t.proj, 320, 180), focal_j(cam_j.proj, 320, 180))
    close(m3_t.normalize(torch.tensor([[3.0, 4.0, 0.0]])),
          m3_j.normalize(jnp.asarray([[3.0, 4.0, 0.0]])))


def test_splat_data_from_numpy_and_random_splats():
    arrays = scene_arrays(64, sh_degree=2, seed=5)
    s = gt.SplatData.from_numpy(*arrays, device="cpu")
    assert s.num_splats == 64 and s.sh_degree == 2
    assert s.device.type == "cpu" and s.means.dtype == torch.float32
    np.testing.assert_array_equal(s.sh.numpy(), arrays[4])
    gen = torch.Generator().manual_seed(0)
    r = gt.random_splats(gen, 1000, sh_degree=1, extent=2.0, device="cpu")
    assert r.sh.shape == (1000, 3, 3) and r.sh_degree == 1
    assert float(r.means.abs().max()) <= 2.0
    assert float(r.colors[:, 3].min()) >= 0.3
    np.testing.assert_allclose(r.quats.norm(dim=1).numpy(), 1.0, rtol=1e-5)
    r2 = gt.random_splats(torch.Generator().manual_seed(0), 1000,
                          sh_degree=1, extent=2.0, device="cpu")
    assert torch.equal(r.means, r2.means)      # the generator decides


def test_render_config_matches_jax_and_validates():
    cfg_t, cfg_j = gt.RenderConfig(), gs.RenderConfig()
    for f in ("width", "height", "sh_degree", "kernel_2d_size", "sort_bits",
              "min_alpha", "tile_size", "lanes", "aux_multiplier",
              "record_precision", "forward_only",
              "max_screen_space_splat_size"):
        assert getattr(cfg_t, f) == getattr(cfg_j, f), f
    assert (cfg_t.tiles_x, cfg_t.tiles_y) == (cfg_j.tiles_x, cfg_j.tiles_y)
    for bad in (dict(backend="pallas"), dict(sh_degree=5), dict(sort_bits=30),
                dict(lanes=3), dict(record_precision="bf16"),
                dict(tile_size=0)):
        with pytest.raises(ValueError):
            gt.RenderConfig(**bad)


@pytest.mark.parametrize("tile", [1, 33, 40, 64, 65, 128])
def test_render_config_takes_every_tile_side(tile):
    """Every side the JAX package's RenderConfig takes builds, with its
    tile grid (the CUDA compositors take up to 64; their wrappers refuse
    more, tests/test_torch_composite.py)."""
    kw = dict(width=200, height=150, tile_size=tile)
    cfg_t, cfg_j = gt.RenderConfig(**kw), gs.RenderConfig(**kw)
    assert (cfg_t.tiles_x, cfg_t.tiles_y, cfg_t.num_tiles) == (
        cfg_j.tiles_x, cfg_j.tiles_y, cfg_j.num_tiles)
