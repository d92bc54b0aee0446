"""The port's Viewer layer (gaussiansplats3d_tpu_torch/viewer) against the
JAX package's: a JAX Viewer and a port Viewer (``device="cpu"``, the
kernels' plain versions) at 64x64 go through the same operations on the
same splats (numpy, from a seed) and their frames are compared; the
render gating, picking, the orbit camera, the octree, the info panel, the
overlays and the errors are compared as well; on a card, a small
multi-scene Viewer against the same viewer on the CPU, with its launches.

Bars.  Frames: error mass, p99.9 of |d| <= 1e-3 and <= 0.1% of the
elements over 1e-2 (never the elementwise max: the hard cut-offs flip on
last-bit differences).  The reveal fade's centre is a float32 mean, which
the port reduces on the device in another order than numpy's pairwise sum,
so it may differ in its last bits: centres and radii within 1e-6
relative.  Picking: the same splat and scene, t within 1e-4 relative
and the hit point within 1e-4 (the ray comes from float32 inverses of
the camera's matrices, computed in another order, and a ray that grazes a
sphere turns that into ~1e-5 of t).
Overlays, camera matrices: within 1e-5 (float32 arithmetic in another
order).  Octree and info panel rows: equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussiansplats3d_tpu as gs
import gaussiansplats3d_tpu_torch as gt
from gaussiansplats3d_tpu import viewer as vj
from gaussiansplats3d_tpu.utils.metrics import FrameStats as FrameStatsJ
from gaussiansplats3d_tpu.viewer import helpers as hj
from gaussiansplats3d_tpu.viewer.fade import VisibleRegion as RegionJ
from gaussiansplats3d_tpu_torch import viewer as vt
from gaussiansplats3d_tpu_torch.utils import metrics
from gaussiansplats3d_tpu_torch.utils.metrics import FrameStats as FrameStatsT
from gaussiansplats3d_tpu_torch.viewer import helpers as ht
from gaussiansplats3d_tpu_torch.viewer.fade import VisibleRegion as RegionT

from torch_port_common import (both_cameras, both_scenes,  # noqa: F401
                               cuda_device, error_mass, scene_arrays)

SIZE = 64
N = 120
EYE = (2.2, 1.4, 2.4)
# the second scene's transform: a rotation of 45 degrees about y, x1.2
ROT = (0.0, 0.38268343, 0.0, 0.92387953)
FRAME_BARS = (1e-3, 1e-3)


@pytest.fixture(autouse=True)
def numpy_decoders(monkeypatch):
    """Both packages on their numpy decoders, not their native libraries
    (both read GS_NATIVE)."""
    monkeypatch.setenv("GS_NATIVE", "0")


def arrays(seed):
    """One scene shape for the whole file (each new shape costs the JAX
    package a compilation): N splats, SH1, sizes x4 so picking hits."""
    return scene_arrays(N, sh_degree=1, seed=seed, scale_mul=4.0)


def viewers(device="cpu", **kw):
    """(JAX Viewer, port Viewer) with the same options; the reveal fade
    off unless asked for."""
    kw.setdefault("width", SIZE)
    kw.setdefault("height", SIZE)
    kw.setdefault("initial_camera_position", EYE)
    kw.setdefault("max_spherical_harmonics_degree", 1)
    kw_t = dict(kw)
    mode = kw.pop("scene_reveal_mode", "Instant")
    kw["scene_reveal_mode"] = vj.SceneRevealMode[mode]
    kw_t["scene_reveal_mode"] = vt.SceneRevealMode[mode]
    for k in ("render_mode", "splat_render_mode"):
        if k in kw:
            enum = type(kw[k]).__name__
            kw_t[k] = getattr(vt, enum)[kw[k].name]
    return vj.Viewer(**kw), vt.Viewer(device=device, **kw_t)


def add_two(v_j, v_t):
    """Scene 0 at +x; scene 1 at -x, rotated and scaled."""
    (a_j, a_t), (b_j, b_t) = (both_scenes(arrays(s)) for s in (1, 2))
    out = []
    for v, a, b in ((v_j, a_j, b_j), (v_t, a_t, b_t)):
        out.append((v.add_splat_scene(a, position=(0.6, 0.0, 0.0)),
                    v.add_splat_scene(b, position=(-0.6, 0.0, 0.0),
                                      rotation=ROT, scale=(1.2, 1.2, 1.2))))
    return out


def assert_frames_match(out_j, out_t, what):
    for key in ("color", "alpha"):
        p999, over = error_mass(np.asarray(out_j[key]), out_t[key].numpy())
        assert p999 <= FRAME_BARS[0] and over <= FRAME_BARS[1], (
            what, key, p999, over)


def both_render(v_j, v_t, what, **kw):
    out_j, out_t = v_j.render(**kw), v_t.render(**kw)
    assert_frames_match(out_j, out_t, what)
    return out_j, out_t


def test_scene_sequence_matches_jax():
    """Two scenes with transforms, then hiding one, fading its opacity and
    moving it: every frame as the JAX viewer's."""
    v_j, v_t = viewers()
    (_, s1_j), (_, s1_t) = add_two(v_j, v_t)
    assert v_t.scene_count == 2
    first, _ = both_render(v_j, v_t, "two scenes")
    assert float(jnp.max(first["alpha"])) > 0.5
    for what, change in (("hidden", {"visible": False}),
                         ("faded", {"visible": True, "opacity": 0.2}),
                         ("moved", {"opacity": 1.0,
                                    "position": (-0.2, 0.3, 0.1)})):
        for s in (s1_j, s1_t):
            for k, val in change.items():
                setattr(s, k, val)
        out_j, _ = both_render(v_j, v_t, what)
        assert np.abs(np.asarray(out_j["color"])
                      - np.asarray(first["color"])).max() > 1e-3, what
    assert np.allclose(v_t.get_splat_scene(1).transform.numpy(),
                       np.asarray(v_j.get_splat_scene(1).transform),
                       atol=1e-6)


def test_reveal_fade_matches_jax():
    """The default reveal fade over several ticks: the same fade state and
    frames, with a faster rate that completes it; then no fade."""
    v_j, v_t = viewers(scene_reveal_mode="Default",
                       scene_fade_in_rate_multiplier=40.0)
    add_two(v_j, v_t)
    r_j, r_t = v_j.visible_region, v_t.visible_region
    np.testing.assert_allclose(r_t.center, r_j.center, rtol=1e-6,
                               atol=1e-6)
    assert r_t.max_splat_distance == pytest.approx(r_j.max_splat_distance,
                                                   rel=1e-6)
    ticks = 0
    while not r_j.complete:
        both_render(v_j, v_t, f"fade tick {ticks}")
        assert r_t.fade_start_radius == pytest.approx(r_j.fade_start_radius,
                                                      rel=1e-6)
        ticks += 1
    assert 2 <= ticks <= 12 and r_t.complete
    both_render(v_j, v_t, "fade complete")


@pytest.mark.parametrize("case", ["stereo", "orthographic", "2d",
                                  "point_cloud", "focal_adjustment"])
def test_render_modes_match_jax(case):
    kw = {"orthographic": {"use_orthographic_camera": True},
          "2d": {"splat_render_mode": vj.SplatRenderMode.TwoD},
          "point_cloud": {"point_cloud_mode": True},
          "focal_adjustment": {"focal_adjustment": 1.5}}.get(case, {})
    v_j, v_t = viewers(**kw)
    add_two(v_j, v_t)
    if case == "stereo":
        pj, pt = v_j.render_stereo(0.3), v_t.render_stereo(0.3)
        for eye in ("left", "right"):
            assert_frames_match(pj[eye], pt[eye], eye)
        assert (pt["left"]["color"] - pt["right"]["color"]).abs().max() \
            > 1e-3
    else:
        out_j, _ = both_render(v_j, v_t, case)
        assert float(jnp.max(out_j["alpha"])) > 0.1


def test_load_options_match_jax(tmp_path):
    """A .splat payload under another extension with the format override,
    optimize_splat_data and the alpha threshold: the same splats, bit for
    bit, and the same frame."""
    from gaussiansplats3d_tpu.io import SceneFormat as FmtJ
    from gaussiansplats3d_tpu_torch.io import SceneFormat as FmtT
    s_j, _ = both_scenes(arrays(3))
    gs.save(s_j, str(tmp_path / "s.splat"))
    odd = tmp_path / "scene.dat"
    odd.write_bytes((tmp_path / "s.splat").read_bytes())
    v_j, v_t = viewers(max_spherical_harmonics_degree=0)   # .splat: SH0
    opts = dict(optimize_splat_data=True, splat_alpha_removal_threshold=140)
    sc_j = v_j.add_splat_scene(str(odd), format=FmtJ.Splat, **opts)
    sc_t = v_t.add_splat_scene(str(odd), format=FmtT.Splat, **opts)
    assert 0 < sc_t.num_splats == sc_j.num_splats < N
    for f in ("means", "scales", "quats", "colors", "sh"):
        np.testing.assert_array_equal(getattr(sc_t.splats, f).numpy(),
                                      np.asarray(getattr(sc_j.splats, f)))
    both_render(v_j, v_t, "load options")


def test_render_gating_matches_jax():
    """OnChange and Never: the same rendered-or-cached pattern over one
    camera sequence (sub-epsilon jitter, a super-epsilon move, a scene
    change, a forced frame)."""
    pattern = {}
    for side in ("jax", "port"):
        for mode in ("OnChange", "Never"):
            v_j, v_t = viewers(render_mode=vj.RenderMode[mode])
            add_two(v_j, v_t)
            v = v_j if side == "jax" else v_t
            base = np.asarray(v.camera.position, np.float64).copy()
            steps = []

            def step(label):
                prev = v._last_frame[1] if v._last_frame else None
                out = v.render()
                steps.append((label, out is not prev))

            step("first")
            step("repeat")
            for k in range(3):
                v.camera.position = base + 2e-5 * np.array(
                    [1.0, -1.0, 1.0]) * (-1.0) ** k
                step(f"jitter {k}")
            v.camera.position = base + np.array([5e-4, 0.0, 0.0])
            step("move")
            v.camera.rotate(0.3, 0.0)
            step("rotate")
            v.get_splat_scene(0).opacity = 0.5
            step("scene change")
            v.force_render_next_frame()
            step("forced")
            step("repeat after forced")
            pattern[side, mode] = steps
    for mode in ("OnChange", "Never"):
        assert pattern["port", mode] == pattern["jax", mode], mode
    assert [r for _, r in pattern["port", "OnChange"]] == [
        True, False, False, False, False, True, True, True, True, False]
    assert [r for _, r in pattern["port", "Never"]] == [True] + [False] * 9


def test_raycast_matches_jax():
    """Sphere and ellipsoid picking through a grid of pixels of the
    composed scene: the same hits (splat, scene, t)."""
    v_j, v_t = viewers()
    add_two(v_j, v_t)
    hits, last = 0, None
    for ellipsoid in (False, True):
        v_j.raycaster.ellipsoid = v_t.raycaster.ellipsoid = ellipsoid
        for x in range(8, SIZE, 12):
            for y in range(8, SIZE, 12):
                h_j, h_t = v_j.raycast(x, y), v_t.raycast(x, y)
                assert (h_j is None) == (h_t is None), (ellipsoid, x, y)
                if h_j is None:
                    continue
                hits, last = hits + 1, h_t
                assert (h_t.splat_index, h_t.scene_index) == (
                    h_j.splat_index, h_j.scene_index), (ellipsoid, x, y)
                assert h_t.t == pytest.approx(h_j.t, rel=1e-4)
                np.testing.assert_allclose(h_t.point, h_j.point, atol=1e-4)
    assert hits >= 10
    v_t.look_at_hit(last)
    np.testing.assert_allclose(v_t.camera.target, last.point)


def test_raycast_holds_float64_where_float32_cancels():
    """Far, small splats, as at the 4K viewer scene (t ~ 8, radii ~ 5e-3):
    the port's sphere and ellipsoid tests in float32 find the hits a
    float64 evaluation finds, with t within 1e-6 of itself.  (The
    squared distance as |rel|^2 - tca^2, or the quadratic's b^2 - 4ac,
    cancels there in float32.)"""
    from gaussiansplats3d_tpu_torch.core import math3d
    from gaussiansplats3d_tpu_torch.viewer import raycaster as rc
    means, scales, quats, _, _ = scene_arrays(200_000, seed=12, extent=2.0,
                                              scale_mul=0.3)
    cam = gt.Camera.look_at((0.0, 3.0, 9.0), (0, 0, 0), aspect=16 / 9,
                            device="cpu")
    ray = rc.Ray.from_camera_and_screen(cam, 1920, 1080, 3840, 2160)
    hits = 0
    for dt in (torch.float32, torch.float64):
        m, sc, q = (torch.from_numpy(a).to(dt) for a in (means, scales,
                                                         quats))
        o, d = ray.origin.to(dt), ray.direction.to(dt)
        rot = math3d.quat_to_rotmat(q)
        inv_s = 1.0 / sc
        ts = (rc._ray_sphere(o, d, m, sc.mean(dim=1)),
              rc._ray_sphere_local(
                  torch.einsum("nji,nj->ni", rot, o[None] - m) * inv_s,
                  torch.einsum("nji,j->ni", rot, d) * inv_s))
        if dt == torch.float32:
            t32 = ts
    for a, b in zip(t32, ts):
        hit = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), hit)
        hits += int(hit.sum())
        rel = ((a.double() - b)[hit].abs() / b[hit]).max()
        assert float(rel) <= 1e-6
    assert hits >= 2


def test_orbit_camera_matches_jax():
    cams = [vj.OrbitCamera(position=(0, 1, 5), target=(0.1, 0, 0),
                           aspect=1.5),
            vt.OrbitCamera(position=(0, 1, 5), target=(0.1, 0, 0),
                           aspect=1.5)]
    for oc in cams:
        oc.rotate(np.pi / 3, 0.2).zoom(1.7).pan(0.4, -0.3)
        oc.set_target((0.2, 0.1, -0.3))
    np.testing.assert_allclose(cams[1].position, cams[0].position,
                               atol=1e-12)
    c_j, c_t = cams[0].camera(), cams[1].camera(device="cpu")
    for f in ("view", "proj", "cam_pos"):
        np.testing.assert_allclose(getattr(c_t, f).numpy(),
                                   np.asarray(getattr(c_j, f)), atol=1e-5)


def test_splat_tree_matches_jax():
    big = scene_arrays(3000, seed=5)
    s_j, s_t = both_scenes(big)
    t_j = vj.SplatTree(max_depth=4, max_centers_per_node=200)
    t_j.process_splats(s_j)
    t_t = vt.SplatTree(max_depth=4, max_centers_per_node=200)
    t_t.process_splats(s_t)
    assert len(t_t.nodes_with_indexes) == len(t_j.nodes_with_indexes) > 8
    for a, b in zip(t_t.nodes_with_indexes, t_j.nodes_with_indexes):
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.min, b.min)
        assert a.depth == b.depth
    lo, hi = np.array([-0.5] * 3), np.array([0.5, 0.2, 0.5])
    np.testing.assert_array_equal(t_t.query_box(lo, hi),
                                  t_j.query_box(lo, hi))


def test_info_panel_matches_jax():
    v_j, v_t = viewers(splat_scale=1.5, focal_adjustment=2.0)
    add_two(v_j, v_t)
    rows = []
    for v, panel, stats in (
            (v_j, vj.InfoPanel(), FrameStatsJ), (v_t, vt.InfoPanel(),
                                                 FrameStatsT)):
        st = stats(wall_ms=20.0, num_splats=2 * N, num_pairs=250,
                   width=SIZE, height=SIZE)
        rows.append((panel.update(v, stats=st,
                                  cursor_position=(1.0, 2.0, 3.0)),
                     panel.format_text(), panel.update(v)))
    assert rows[1] == rows[0]
    assert rows[1][0]["fps"] == "50"


def overlay_camera():
    cam_j = gs.Camera.look_at((2.2, 1.3, 2.4), (0, 0, 0), fov_y_deg=60.0,
                              aspect=96 / 80)
    return both_cameras(cam_j)


def test_overlays_match_jax():
    """project_to_screen, the focus marker, the mesh cursor, the control
    plane (in front of and behind the camera) and apply_overlay."""
    cam_j, cam_t = overlay_camera()
    w, h = 96, 80
    for pos in ((0.1, 0.2, -0.1), (6.0, 4.0, 6.0)):
        px_j, w_j = hj.project_to_screen(cam_j, pos, w, h)
        px_t, w_t = ht.project_to_screen(cam_t, pos, w, h)
        np.testing.assert_allclose(px_t.numpy(), np.asarray(px_j),
                                   rtol=1e-5, atol=1e-4)
        assert float(w_t) == pytest.approx(float(w_j), rel=1e-5)
        for fj, ft, args in (
                (hj.focus_marker_overlay, ht.focus_marker_overlay,
                 (pos, w, h, 0.7)),
                (hj.mesh_cursor_overlay, ht.mesh_cursor_overlay,
                 (pos, w, h)),
                (hj.control_plane_overlay, ht.control_plane_overlay,
                 (pos, (0.0, 1.0, 0.0), w, h))):
            o_j, o_t = np.asarray(fj(cam_j, *args)), ft(cam_t, *args).numpy()
            assert o_t.shape == o_j.shape == (h, w, 4)
            p999, over = error_mass(o_j, o_t)
            assert p999 <= 1e-5 and over <= 1e-3, (ft.__name__, pos)
    rng = np.random.default_rng(3)
    img = rng.uniform(size=(h, w, 3)).astype(np.float32)
    ov = rng.uniform(size=(h, w, 4)).astype(np.float32)
    np.testing.assert_allclose(
        ht.apply_overlay(torch.from_numpy(img), torch.from_numpy(ov)).numpy(),
        np.asarray(hj.apply_overlay(jnp.asarray(img), jnp.asarray(ov))),
        atol=1e-6)


def test_composite_with_depth_matches_jax():
    """Depth compositing over the same splat layer (color, alpha, depth
    with empty pixels) and other content in front, behind and mixed."""
    rng = np.random.default_rng(4)
    h, w = 40, 48
    alpha = rng.uniform(size=(h, w)).astype(np.float32)
    alpha[rng.uniform(size=(h, w)) < 0.3] = 0.0
    layer = {"color": rng.uniform(size=(h, w, 3)).astype(np.float32)
             * alpha[..., None],
             "alpha": alpha,
             "depth": np.where(alpha > 0, rng.uniform(1, 5, (h, w)),
                               0.0).astype(np.float32)}
    other = rng.uniform(size=(h, w, 3)).astype(np.float32)
    for depth in (np.zeros((h, w)), np.full((h, w), 1e6),
                  rng.uniform(1, 5, (h, w))):
        depth = depth.astype(np.float32)
        r_j = hj.composite_with_depth(
            {k: jnp.asarray(v) for k, v in layer.items()},
            jnp.asarray(other), jnp.asarray(depth))
        r_t = ht.composite_with_depth(
            {k: torch.from_numpy(v) for k, v in layer.items()},
            torch.from_numpy(other), torch.from_numpy(depth))
        for k in ("color", "depth"):
            np.testing.assert_allclose(r_t[k].numpy(), np.asarray(r_j[k]),
                                       atol=1e-6)


def test_max_scenes_and_dispose_raise_like_jax():
    (s_j, s_t) = both_scenes(scene_arrays(8, seed=6))
    v_j, v_t = viewers()
    errors = []
    for v, s in ((v_j, s_j), (v_t, s_t)):
        for _ in range(gt.MAX_SCENES):
            v.add_splat_scene(s)
        with pytest.raises(ValueError) as e:
            v.add_splat_scene(s)
        errors.append(str(e.value))
        v.remove_splat_scene(0)
        v.remove_splat_scenes([0, 1])
        assert v.scene_count == gt.MAX_SCENES - 3
        v.dispose()
        with pytest.raises(RuntimeError) as e:
            v.render()
        errors.append(str(e.value))
        with pytest.raises(RuntimeError):
            v.add_splat_scene(s)
    assert errors[2:] == errors[:2]
    assert gt.MAX_SCENES == gs.MAX_SCENES


def test_fade_opacity_ramp_matches_jax():
    """The projection-side fade: full opacity inside the radius, linear to
    0 over 0.75 world units past it, as the JAX package projects it."""
    from gaussiansplats3d_tpu.render.projection import project_splats as pj
    from gaussiansplats3d_tpu_torch.render.projection import \
        project_splats as pt
    means = np.array([[0, 0, 0], [1.0, 0, 0], [5.0, 0, 0]], np.float32)
    arr = (means, np.full((3, 3), 0.1, np.float32),
           np.tile(np.float32([0, 0, 0, 1]), (3, 1)),
           np.ones((3, 4), np.float32), np.zeros((3, 0, 3), np.float32))
    s_j, s_t = both_scenes(arr)
    cam_j, cam_t = both_cameras(gs.Camera.look_at((0, 0, 8.0), (0, 0, 0)))
    ops = []
    for proj, s, cam, cfg in ((pj, s_j, cam_j, gs.RenderConfig(32, 32)),
                              (pt, s_t, cam_t, gt.RenderConfig(32, 32))):
        faded = proj(s, cam, cfg, fade_params=(np.zeros(3), 0.625))
        ops.append(np.asarray(faded.opacity)
                   / np.maximum(np.asarray(proj(s, cam, cfg).opacity),
                                1e-12))
    np.testing.assert_allclose(ops[1], ops[0], atol=1e-6)
    np.testing.assert_allclose(ops[1], [1.0, 0.5, 0.0], atol=1e-6)


def test_visible_region_matches_jax():
    """The fade animation tick by tick, in each reveal mode, for a final
    and a progressive build, until it completes."""
    pts = np.random.default_rng(0).normal(size=(100, 3)).astype(np.float32)
    for mode in ("Default", "Gradual", "Instant"):
        for final in (True, False):
            r_j, r_t = RegionJ(), RegionT()
            r_j.update_region(pts, final_build=final)
            r_t.update_region(torch.from_numpy(pts), final_build=final)
            for _ in range(3000):
                f_j = r_j.tick(vj.SceneRevealMode[mode])
                f_t = r_t.tick(vt.SceneRevealMode[mode])
                assert (f_j is None) == (f_t is None)
                if f_j is None:
                    break
                np.testing.assert_allclose(f_t[0], f_j[0], rtol=1e-6,
                                           atol=1e-6)
                assert f_t[1] == pytest.approx(f_j[1], rel=1e-6)
            assert r_t.complete == r_j.complete
            assert r_t.complete or mode == "Instant" or not final


def test_viewer_gradual_fade_converges_like_jax():
    """Gradual reveal: the first frame is dimmer than the settled one, and
    the settled frame is the no-fade frame, in both packages."""
    v_j, v_t = viewers(scene_reveal_mode="Gradual")
    add_two(v_j, v_t)
    early_j, early_t = both_render(v_j, v_t, "gradual, first frame")
    for v in (v_j, v_t):
        while not v.visible_region.complete:
            v.visible_region.tick(v.scene_reveal_mode)
    settled_j, settled_t = both_render(v_j, v_t, "gradual, settled")
    assert float(early_t["color"].sum()) < 0.99 * float(
        settled_t["color"].sum())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ThreeD", "TwoD"])
def test_cuda_viewer_matches_cpu(cuda_device, mode):
    """Two scenes on the card against the same viewer on the CPU, with the
    fade running: frames by error mass; B1 (3D) or B3 (2D) once a frame
    and stereo twice; OnChange's repeat launches nothing."""
    from gaussiansplats3d_tpu_torch.render import cuda_rasterize as cr
    from gaussiansplats3d_tpu_torch.render import cuda_surfel as cs
    frames = {}
    for dev in ("cpu", cuda_device):
        v = vt.Viewer(width=96, height=80, initial_camera_position=EYE,
                      max_spherical_harmonics_degree=1,
                      splat_render_mode=vt.SplatRenderMode[mode],
                      render_mode=vt.RenderMode.OnChange, device=dev)
        for seed, pos in ((1, (0.6, 0, 0)), (2, (-0.6, 0, 0))):
            v.add_splat_scene(gt.SplatData.from_numpy(*arrays(seed),
                                                      device="cpu"),
                              position=pos, rotation=ROT)
        cr.reset_launches()
        cs.reset_launches()
        out = [v.render()]
        v.get_splat_scene(1).opacity = 0.4
        out.append(v.render())
        pair = v.render_stereo(0.3)
        out += [pair["left"], pair["right"]]
        launches = (metrics.total(cr.LAUNCHES), metrics.total(cs.LAUNCHES))
        v.visible_region.fade_start_radius = v.visible_region.radius
        last = v.render()
        assert v.render() is last
        frames[str(dev)] = (out, launches)
    cpu, card = frames["cpu"], frames[str(cuda_device)]
    assert card[1] == ((4, 0) if mode == "ThreeD" else (0, 4))
    for a, b in zip(cpu[0], card[0]):
        for k in ("color", "alpha"):
            p999, over = error_mass(a[k].numpy(), b[k].cpu().numpy())
            assert p999 <= FRAME_BARS[0] and over <= FRAME_BARS[1], k
