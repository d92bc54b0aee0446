"""The port's IO remainder and the core it needs, against the JAX package:
fetch over a loopback HTTP server (nothing leaves the machine) with
headers, progress and abort; load from a URL; progressive snapshots at
the same byte prefixes; the viewer's progressive load; optimize; SH
rotation and baking; SplatData.concatenate; the transform helpers of
math3d.

Bars.  Decoders, snapshots, optimize and concatenate: bit for bit (both
packages on their numpy decoders, GS_NATIVE=0).  SH rotation, baking and
the math3d helpers: within 1e-5 (float32 arithmetic in another order).
A baked scene's render against the dynamic transform's: error mass,
p99.9 of |d| <= 1e-3 and <= 0.1% of elements over 1e-2."""

import http.server
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussiansplats3d_tpu as gs
import gaussiansplats3d_tpu_torch as gt
from gaussiansplats3d_tpu.core import math3d as m3_j
from gaussiansplats3d_tpu.core import sh as sh_j
from gaussiansplats3d_tpu.io import optimize as opt_j
from gaussiansplats3d_tpu.io.progressive import ProgressiveLoader as LoaderJ
from gaussiansplats3d_tpu_torch.core import math3d as m3_t
from gaussiansplats3d_tpu_torch.core import sh as sh_t
from gaussiansplats3d_tpu_torch.io import fetch as fetch_t
from gaussiansplats3d_tpu_torch.io import optimize as opt_t
from gaussiansplats3d_tpu_torch.io.formats import SceneFormat as FmtT
from gaussiansplats3d_tpu_torch.io.progressive import \
    ProgressiveLoader as LoaderT

from torch_port_common import both_scenes, error_mass, scene_arrays

FIELDS = ("means", "scales", "quats", "colors", "sh")


@pytest.fixture(autouse=True)
def numpy_decoders(monkeypatch):
    """Both packages on their numpy decoders, not their native libraries
    (both read GS_NATIVE)."""
    monkeypatch.setenv("GS_NATIVE", "0")


def assert_same_bits(a_j, b_t, what=""):
    assert a_j.num_splats == b_t.num_splats, what
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(b_t, f).numpy(),
                                      np.asarray(getattr(a_j, f)),
                                      err_msg=f"{what} {f}")


def scenes(n=300, sh_degree=1, seed=2):
    return both_scenes(scene_arrays(n, sh_degree=sh_degree, seed=seed,
                                    extent=3.0))


@pytest.fixture()
def http_root(tmp_path):
    """A loopback HTTP server over tmp_path that records each request's
    headers."""
    seen = []

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=str(tmp_path), **kw)

        def do_GET(self):
            seen.append(dict(self.headers))
            super().do_GET()

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield tmp_path, f"http://127.0.0.1:{httpd.server_address[1]}", seen
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def test_fetch_headers_progress_and_url_load_match_jax(http_root):
    tmp_path, base, seen = http_root
    s_j, s_t = scenes(n=120)
    gt.save(s_t, str(tmp_path / "scene.ksplat"))
    events = []
    r_t = gt.load(f"{base}/scene.ksplat?v=1",
                  on_progress=lambda pct, label, chunk, total:
                  events.append((pct, total)),
                  headers={"X-Splat-Token": "abc"}, device="cpu")
    assert seen[-1].get("X-Splat-Token") == "abc"
    assert events and events[-1][0] == 100.0
    assert events[-1][1] == (tmp_path / "scene.ksplat").stat().st_size
    r_j = gs.load(f"{base}/scene.ksplat?v=1")
    assert_same_bits(r_j, r_t, "url")
    assert_same_bits(r_j, gt.load(str(tmp_path / "scene.ksplat"),
                                  device="cpu"), "path")
    body_t = fetch_t.fetch_with_progress(f"{base}/scene.ksplat",
                                         headers={"X-A": "1"})
    assert body_t == (tmp_path / "scene.ksplat").read_bytes()


def test_fetch_abort_and_file_progress_match_jax(tmp_path):
    from gaussiansplats3d_tpu.io import fetch as fetch_j
    big = tmp_path / "big.bin"
    big.write_bytes(b"x" * (1 << 20))
    calls = {}
    for name, mod in (("jax", fetch_j), ("port", fetch_t)):
        ev = threading.Event()
        got = calls[name] = []

        def cb(pct, label, chunk, total, got=got, ev=ev):
            got.append((pct, label, len(chunk), total))
            ev.set()                    # abort after the first chunk

        with pytest.raises(mod.AbortedError):
            mod.fetch_with_progress(str(big), cb, ev, chunk_size=1 << 16)
    assert calls["port"] == calls["jax"] and len(calls["port"]) == 1
    assert gt.io.AbortedError is fetch_t.AbortedError
    seen = [[], []]
    gs.io.fetch_with_progress(str(big), lambda *a: seen[0].append(a[:2]),
                              chunk_size=1 << 18)
    gt.io.fetch_with_progress(str(big), lambda *a: seen[1].append(a[:2]),
                              chunk_size=1 << 18)
    assert seen[1] == seen[0] and seen[1][-1] == (100.0, "100%")


def _snapshots(loader, data, cuts):
    out, fed = [], 0
    for cut in cuts:
        loader.feed(data[fed:cut])
        fed = cut
        out.append((loader.supports_incremental, loader.available_splats(),
                    loader.snapshot()))
    return out, loader.finalize()


@pytest.mark.parametrize("ext,level", [("ksplat", 0), ("ksplat", 1),
                                       ("splat", None), ("ply", None)])
def test_progressive_snapshots_match_jax(tmp_path, ext, level):
    """The same byte prefixes give the same snapshots, bit for bit, with
    the default snapshot threshold and with a threshold of 1."""
    s_j, s_t = scenes(n=700, sh_degree=0 if ext == "splat" else 1)
    path = str(tmp_path / f"s.{ext}")
    gs.save(s_j, path, **({"compression_level": level}
                          if level is not None else {}))
    data = open(path, "rb").read()
    cuts = sorted({1, 100, len(data) // 7, len(data) // 3, len(data) // 2,
                   len(data) - 5, len(data)})
    for min_new in (1, 200):
        snaps_j, fin_j = _snapshots(LoaderJ.for_path(path, min_new), data,
                                    cuts)
        snaps_t, fin_t = _snapshots(LoaderT.for_path(path, min_new,
                                                     device="cpu"),
                                    data, cuts)
        grew = 0
        for (inc_j, av_j, a), (inc_t, av_t, b) in zip(snaps_j, snaps_t):
            assert (inc_t, av_t) == (inc_j, av_j)
            assert (a is None) == (b is None)
            if a is not None:
                assert_same_bits(a, b, f"{ext} prefix")
                grew += 1
        assert grew >= (4 if min_new == 1 else 2)
        assert_same_bits(fin_j, fin_t, f"{ext} final")
        assert fin_t.num_splats == 700


@pytest.mark.parametrize("kind", ["ascii_ply", "spz"])
def test_progressive_buffered_formats_match_jax(tmp_path, kind):
    """Formats with no valid prefix buffer up: no snapshot, then the whole
    decode at finalize."""
    if kind == "spz":
        s_j, _ = scenes(n=50, sh_degree=0)
        gs.save(s_j, str(tmp_path / "s.spz"))
        data = (tmp_path / "s.spz").read_bytes()
        mk_j, mk_t = (lambda: LoaderJ.for_path("s.spz"),
                      lambda: LoaderT.for_path("s.spz", device="cpu"))
    else:
        pts = np.random.default_rng(0).normal(size=(20, 3))
        header = ("ply\nformat ascii 1.0\nelement vertex 20\n"
                  "property float x\nproperty float y\nproperty float z\n"
                  "end_header\n")
        data = (header + "\n".join(" ".join(f"{v:.6f}" for v in row)
                                   for row in pts) + "\n").encode()
        from gaussiansplats3d_tpu.io.formats import SceneFormat as FmtJ
        mk_j, mk_t = (lambda: LoaderJ(FmtJ.Ply, 1),
                      lambda: LoaderT(FmtT.Ply, 1, device="cpu"))
    cuts = [len(data) // 2, len(data)]
    snaps_j, fin_j = _snapshots(mk_j(), data, cuts)
    snaps_t, fin_t = _snapshots(mk_t(), data, cuts)
    assert [s[2] for s in snaps_t] == [None, None]
    assert [s[:2] for s in snaps_t] == [s[:2] for s in snaps_j]
    assert_same_bits(fin_j, fin_t, kind)


def test_viewer_progressive_load_matches_jax(tmp_path):
    """add_splat_scene_progressive of a binary .ply: the same updates (at
    the same fractions, with the same splat counts) and the full scene at
    the end; then the viewer renders it."""
    s_j, _ = scenes(n=9000, sh_degree=1)
    path = str(tmp_path / "s.ply")
    gs.save(s_j, path)
    kw = dict(width=32, height=32, max_spherical_harmonics_degree=1,
              initial_camera_position=(4.0, 2.0, 4.0))
    v_j = gs.Viewer(scene_reveal_mode=gs.viewer.SceneRevealMode.Instant,
                    **kw)
    v_t = gt.Viewer(scene_reveal_mode=gt.viewer.SceneRevealMode.Instant,
                    device="cpu", **kw)
    updates = [[], []]
    sc_j = v_j.add_splat_scene_progressive(
        path, on_update=lambda s, f: updates[0].append((s.num_splats, f)),
        position=(0.1, 0.0, 0.0))
    sc_t = v_t.add_splat_scene_progressive(
        path, on_update=lambda s, f: updates[1].append((s.num_splats, f)),
        position=(0.1, 0.0, 0.0))
    assert updates[1] == updates[0] and len(updates[1]) >= 2
    assert updates[1][0][0] < 9000
    assert_same_bits(sc_j.splats, sc_t.splats, "progressive final")
    assert_same_bits(gs.load(path), sc_t.splats, "plain load")
    np.testing.assert_array_equal(sc_t.position, sc_j.position)
    assert v_t.visible_region.final_build
    assert v_t.visible_region.max_splat_distance == pytest.approx(
        v_j.visible_region.max_splat_distance, rel=1e-6)
    out = v_t.render()
    assert float(out["alpha"].max()) > 0.1


@pytest.mark.parametrize("section_size", [None, 128])
def test_optimize_matches_jax(section_size):
    arrays = scene_arrays(400, sh_degree=1, seed=2, extent=3.0)
    arrays[3][:60, 3] = 0.01                 # under the alpha threshold
    s_j, s_t = both_scenes(arrays)
    secs_j = opt_j.optimize_splat_data(s_j, scene_center=(0.2, 0.0, -0.1),
                                       section_size=section_size,
                                       alpha_removal_threshold=10)
    secs_t = opt_t.optimize_splat_data(s_t, scene_center=(0.2, 0.0, -0.1),
                                       section_size=section_size,
                                       alpha_removal_threshold=10)
    assert len(secs_t) == len(secs_j) == (1 if section_size is None else 3)
    for a, b in zip(secs_j, secs_t):
        assert_same_bits(a, b, "section")
    assert sum(s.num_splats for s in secs_t) == 340


def test_concatenate_matches_jax():
    parts = [both_scenes(scene_arrays(n, sh_degree=d, seed=n))
             for n, d in ((30, 0), (40, 2), (50, 1))]
    cat_j = gs.SplatData.concatenate([p[0] for p in parts])
    cat_t = gt.SplatData.concatenate([p[1] for p in parts])
    assert cat_t.sh_degree == 2
    assert_same_bits(cat_j, cat_t, "concatenate")


def test_splatdata_to_moves_every_field():
    """SplatData.to, which the Viewer uses for splats given on another
    device: every field moves, the values stay the JAX scene's bit for
    bit."""
    s_j, s_t = both_scenes(scene_arrays(30, sh_degree=1, seed=3))
    assert_same_bits(s_j, s_t.to("cpu"), "to cpu")
    meta = s_t.to("meta")
    for f in ("means", "scales", "quats", "colors", "sh"):
        assert getattr(meta, f).device.type == "meta"
        assert getattr(meta, f).shape == getattr(s_t, f).shape


def _rotation(seed):
    q = np.random.default_rng(seed).normal(size=4).astype(np.float32)
    return q / np.linalg.norm(q)


def test_math3d_transforms_match_jax():
    rng = np.random.default_rng(8)
    for seed in range(4):
        q = _rotation(seed)
        r_j = m3_j.quat_to_rotmat(jnp.asarray(q))
        r_t = m3_t.quat_to_rotmat(torch.from_numpy(q))
        np.testing.assert_allclose(m3_t.rotmat_to_quat(r_t).numpy(),
                                   np.asarray(m3_j.rotmat_to_quat(r_j)),
                                   atol=1e-5)
    a, b = (rng.normal(size=(5, 4)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        m3_t.quat_multiply(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(m3_j.quat_multiply(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-5)
    trs = ((0.4, -0.2, 0.3), tuple(_rotation(9)), (1.3, 0.7, 1.1))
    for args in (trs, (None, None, None), (trs[0], None, None)):
        m_j = m3_j.compose_transform(*args)
        m_t = m3_t.compose_transform(*args, device="cpu")
        assert m_t.dtype == torch.float32
        np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), atol=1e-6)
    pts = rng.normal(size=(20, 3)).astype(np.float32)
    np.testing.assert_allclose(
        m3_t.transform_points(m_t, torch.from_numpy(pts)).numpy(),
        np.asarray(m3_j.transform_points(m_j, jnp.asarray(pts))), atol=1e-5)


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_rotate_sh_matches_jax(degree):
    k = {1: 3, 2: 8, 3: 15}[degree]
    coeffs = (np.random.default_rng(degree).normal(size=(6, k, 3)) * 0.3
              ).astype(np.float32)
    rot = np.array(m3_j.quat_to_rotmat(jnp.asarray(_rotation(degree))))
    out_j = sh_j.rotate_sh(jnp.asarray(coeffs), jnp.asarray(rot), degree)
    out_t = sh_t.rotate_sh(torch.from_numpy(coeffs), torch.from_numpy(rot),
                           degree)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5)
    if degree == 2:
        np.testing.assert_allclose(
            sh_t.sh2_rotation_matrix(torch.from_numpy(rot)).numpy(),
            np.asarray(sh_j.sh2_rotation_matrix(jnp.asarray(rot))),
            atol=1e-5)


def test_bake_transform_matches_jax_and_the_dynamic_render():
    """bake_transform as the JAX package bakes it; and, in the port, the
    baked scene renders like the same transform passed dynamically."""
    arrays = scene_arrays(300, sh_degree=2, seed=9)
    s_j, s_t = both_scenes(arrays)
    r = np.asarray(m3_j.quat_to_rotmat(jnp.asarray(_rotation(11))))
    tf = np.eye(4, dtype=np.float32)
    tf[:3, :3] = 1.3 * r
    tf[:3, 3] = [0.4, -0.2, 0.3]
    b_j = gs.bake_transform(s_j, tf)
    b_t = gt.bake_transform(s_t, tf)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(b_t, f).numpy(),
                                   np.asarray(getattr(b_j, f)), atol=1e-5,
                                   err_msg=f)
    cam = gt.Camera.look_at((2.5, 1.5, 2.5), (0, 0, 0), device="cpu")
    cfg = gt.RenderConfig(width=64, height=64, sh_degree=2, sort_bits=20)
    dyn = gt.render(s_t, cam, cfg, transforms=torch.from_numpy(tf)[None],
                    scene_indices=torch.zeros(300, dtype=torch.int32))
    stat = gt.render(b_t, cam, cfg)
    p999, over = error_mass(dyn["color"].numpy(), stat["color"].numpy())
    assert p999 <= 1e-3 and over <= 1e-3
