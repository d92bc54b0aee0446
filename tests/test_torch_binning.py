"""Port binning (render/binning.py::bin_sort_records) against the JAX
package's, on the JAX package's own ProjectedSplats (passed as numpy).

Bars: exact.  Tile starts, counts, total pairs and overflow are identical,
and with forward_only=False (slot id breaks depth ties, as in the JAX sort)
so is every record, bit for bit, inside every tile's window.  With
forward_only=True the tie order is open in both packages, so the windows
hold the same records in some order.  Each record codec's
quantise-dequantise equals the JAX pack/unpack round trip bit for bit.

Gradients: every codec passes a cotangent through unchanged (straight
through, in float32), and the gradient of a weighted sum of the in-window
records reaches each projected field as the JAX package's custom VJP sends
it there.  Bars, per field, |d| normalised by the field's max |JAX|:
f32 p99.9 <= 1e-5 (the same sums; the JAX package's aux segments are
differences of a running prefix sum); mixed and packed p99.9 <= 1e-2 (the
JAX package rounds every cotangent but the positions' to bf16, a relative
2^-9 per pair, which the port keeps in float32).

The record gather's backward (binning.gather_bwd, its plain version here)
is held to the gradient of index_select (autograd's index_add_, in
float64) for a random cotangent over every slot, those outside every
tile's window too, on each kind of slot layout: |d| <= 1e-6 times the
same sum of |cotangent| (float32 rounding of the sums)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussiansplats3d_tpu as gs
import gaussiansplats3d_tpu_torch as gt
from gaussiansplats3d_tpu.render import binning as bin_j
from gaussiansplats3d_tpu.render import projection as proj_j
from gaussiansplats3d_tpu_torch.render import binning as bin_t
from gaussiansplats3d_tpu_torch.render import projection as proj_t
from gaussiansplats3d_tpu_torch.render import surfel as surf_t
from gaussiansplats3d_tpu_torch.render.projection import ProjectedSplats

from torch_gather import (capture_gathers, guarded_gather_bwd,
                          index_add_grad, random_gather, tail_slots)
from torch_port_common import (both_scenes, cuda_device,  # noqa: F401
                               error_mass, scene_arrays)

DIFF_FIELDS = ("xs", "ys", "conic_a", "conic_b", "conic_c", "col_r", "col_g",
               "col_b", "opacity", "depth")


def _jax_projection(n, seed, eye, scale_mul, **cfg_kw):
    arrays = scene_arrays(n, sh_degree=1, seed=seed, scale_mul=scale_mul)
    s_j, _ = both_scenes(arrays)
    cam = gs.Camera.look_at(eye, (0, 0, 0), fov_y_deg=60, aspect=4 / 3)
    cfg_j = gs.RenderConfig(width=256, height=192, sh_degree=1, **cfg_kw)
    return proj_j.project_splats(s_j, cam, cfg_j), cfg_j


def _port_projection(p_j):
    fields = {f: torch.from_numpy(np.array(getattr(p_j, f)))
              for f in ("xs", "ys", "conic_a", "conic_b", "conic_c", "col_r",
                        "col_g", "col_b", "opacity", "depth", "rx", "ry",
                        "mask")}
    return ProjectedSplats(**fields)


def _jax_records(pairs, depth):
    rows = [pairs.xs, pairs.ys, pairs.cas, pairs.cbs, pairs.ccs, pairs.crs,
            pairs.cgs, pairs.cbs2]
    if depth:
        rows.append(pairs.depths)
    rows += [pairs.opas, pairs.rxs, pairs.rys]
    return np.stack([np.asarray(r) for r in rows])


def _window_slots(starts, counts):
    return np.concatenate([np.arange(s, s + c) for s, c in
                           zip(starts, counts)] + [np.zeros(0, np.int64)])


def _bin_both(p_j, cfg_j, **kw):
    cfg_t = gt.RenderConfig(width=cfg_j.width, height=cfg_j.height,
                            sh_degree=cfg_j.sh_degree, **kw)
    pairs_j = bin_j.bin_sort_records(p_j, cfg_j.replace(**kw))
    pairs_t = bin_t.bin_sort_records(_port_projection(p_j), cfg_t)
    starts, counts = np.asarray(pairs_j.tile_starts), np.asarray(
        pairs_j.tile_counts)
    np.testing.assert_array_equal(pairs_t.tile_starts.numpy(), starts)
    np.testing.assert_array_equal(pairs_t.tile_counts.numpy(), counts)
    assert int(pairs_t.total_pairs) == int(pairs_j.total_pairs)
    assert int(pairs_t.overflow) == int(pairs_j.overflow)
    assert pairs_t.capacity == pairs_j.capacity
    rec_j = _jax_records(pairs_j, kw.get("return_depth", False))
    rec_t = pairs_t.records.numpy()
    assert rec_t.shape == rec_j.shape
    return pairs_j, rec_t, rec_j, _window_slots(starts, counts)


@pytest.mark.parametrize("prec", ["f32", "mixed", "packed"])
@pytest.mark.parametrize("depth", [False, True])
def test_binning_matches_jax_exactly(prec, depth):
    p_j, cfg_j = _jax_projection(1500, 21, (2.5, 1.5, 2.5), 1.0)
    pairs_j, rec_t, rec_j, slots = _bin_both(
        p_j, cfg_j, record_precision=prec, return_depth=depth)
    assert slots.size > 1000 and int(pairs_j.overflow) == 0
    np.testing.assert_array_equal(rec_t[:, slots].view(np.uint32),
                                  rec_j[:, slots].view(np.uint32))


@pytest.mark.parametrize("kw", [
    dict(record_precision="f32"),                  # aux overflow > 0
    dict(record_precision="packed"),
    dict(record_precision="mixed", aux_multiplier=0.0),   # no aux path
    dict(record_precision="mixed", lanes=4),
    dict(record_precision="f32", lanes=1),
], ids=["overflow_f32", "overflow_packed", "no_aux", "lanes4", "lanes1"])
def test_binning_zoomed_in_overflow_matches_jax(kw):
    p_j, cfg_j = _jax_projection(1500, 22, (1.2, 0.7, 1.2), 6.0)
    pairs_j, rec_t, rec_j, slots = _bin_both(p_j, cfg_j, **kw)
    assert int(pairs_j.overflow) > 0
    np.testing.assert_array_equal(rec_t[:, slots].view(np.uint32),
                                  rec_j[:, slots].view(np.uint32))


@pytest.mark.parametrize("prec", ["mixed", "packed"])
def test_binning_forward_only_matches_jax_up_to_tie_order(prec):
    p_j, cfg_j = _jax_projection(1500, 23, (2.5, 1.5, 2.5), 1.0)
    pairs_j, rec_t, rec_j, slots = _bin_both(
        p_j, cfg_j, record_precision=prec, forward_only=True)
    tile = np.repeat(np.arange(cfg_j.num_tiles),
                     np.asarray(pairs_j.tile_counts))

    def canon(rec):
        cols = np.concatenate([tile[None].astype(np.float64),
                               rec[:, slots].astype(np.float64)])
        return cols[:, np.lexsort(cols[::-1])]

    np.testing.assert_array_equal(canon(rec_t), canon(rec_j))


def test_codecs_match_jax_round_trips_bit_for_bit():
    rng = np.random.default_rng(24)

    def same(a_t, a_j):
        np.testing.assert_array_equal(
            a_t.numpy().view(np.uint32), np.asarray(a_j).view(np.uint32))

    # f16 pairs: normal, subnormal, overflow-to-inf, signed values
    v = np.concatenate([rng.normal(0, 3, 3000), rng.normal(0, 1e-6, 500),
                        [7e4, -7e4, 65504.0, 0.0, -0.0, 1e-8]]
                       ).astype(np.float32)
    hi, lo = bin_j._unpack_f16_pair(bin_j._pack_f16_pair(
        jnp.asarray(v), jnp.asarray(v[::-1])))
    same(bin_t.f16_round(torch.from_numpy(v)), hi)
    same(bin_t.f16_round(torch.from_numpy(v[::-1].copy())), lo)
    # u16 radius fixed point (1/16 px, truncating)
    r = np.concatenate([rng.uniform(0, 4095.9375, 3000),
                        np.arange(0, 64) / 16.0]).astype(np.float32)
    hi, lo = bin_j._unpack_u16_pair(bin_j._pack_u16_pair(
        jnp.asarray(r), jnp.asarray(r[::-1])))
    same(bin_t.u16r_round(torch.from_numpy(r)), hi)
    # packed positions, both fixed-point scales, clipped at both ends
    x = rng.uniform(-1500.0, 6000.0, 4000).astype(np.float32)
    for width in (1920, 3840):
        cfg = gs.RenderConfig(width=width, height=1080)
        scale = bin_j._px_scale_for(cfg)
        assert bin_t.px_scale_for(gt.RenderConfig(width=width,
                                                  height=1080)) == scale
        hi, _ = bin_j._unpack_px_pair(bin_j._pack_px_pair(
            jnp.asarray(x), jnp.asarray(x), scale), scale)
        same(bin_t.px_round(torch.from_numpy(x), scale), hi)
        same(bin_t.px_round(torch.from_numpy(x), scale),
             bin_j._px_quantize(jnp.asarray(x), scale))
    # u8 log radius (with the f16 conic c that shares its word)
    rr = np.concatenate([rng.uniform(0, 5000, 3000), rng.uniform(0, 4, 500),
                         [0.0, 1e-7, 4096.0]]).astype(np.float32)
    cc = rng.normal(0, 1, rr.size).astype(np.float32)
    cc_j, rx_j, ry_j = bin_j._unpack_f16u8u8(bin_j._pack_f16u8u8(
        jnp.asarray(cc), jnp.asarray(rr), jnp.asarray(rr[::-1])))
    same(bin_t.rad_round_u8(torch.from_numpy(rr)), rx_j)
    same(bin_t.rad_round_u8(torch.from_numpy(rr[::-1].copy())), ry_j)
    same(bin_t.f16_round(torch.from_numpy(cc)), cc_j)
    np.testing.assert_array_equal(           # the whole u8 decode table
        np.array(bin_t._RAD_DECODE_BITS, np.uint32),
        np.asarray(bin_j._rad_decode_u8(jnp.arange(256, dtype=jnp.uint32))
                   ).view(np.uint32))
    dec = bin_t.rad_round_u8(torch.from_numpy(rr))
    same(bin_t.rad_round_u8(dec), bin_j._rad_decode_u8(
        bin_j._rad_encode_u8(jnp.asarray(dec.numpy()))))
    # u8 colour + opacity, with exact round-half-to-even cases
    col = np.concatenate([rng.uniform(-0.1, 2.2, 3000),
                          (np.arange(40) + 0.5) / 127.5]).astype(np.float32)
    opa = rng.uniform(0, 1, col.size).astype(np.float32)
    r_j, g_j, b_j, a_j = bin_j._unpack_rgba8(bin_j._pack_rgba8(
        jnp.asarray(col), jnp.asarray(col), jnp.asarray(col),
        jnp.asarray(opa)))
    same(bin_t.u8_round(torch.from_numpy(col), 127.5), r_j)
    same(bin_t.u8_round(torch.from_numpy(opa), 255.0), a_j)


def test_codecs_pass_the_cotangent_through():
    """A cotangent of 1e-9 (f16 would flush it to 0) and 1.234567e-3 (f16
    would round it) come back bit for bit through every codec."""
    g = torch.tensor([1e-9, 1.234567e-3, -2.5, 0.0])
    for codec in (bin_t.f16_round, bin_t.rad_round_u8,
                  lambda v: bin_t.px_round(v, 16.0),
                  lambda v: bin_t.u8_round(v, 127.5),
                  lambda v: bin_t.u8_round(v, 255.0)):
        v = torch.tensor([0.3, 1.7, 40.0, 0.9], requires_grad=True)
        out = codec(v)
        out.backward(g)
        np.testing.assert_array_equal(v.grad.numpy().view(np.uint32),
                                      g.numpy().view(np.uint32))
        np.testing.assert_array_equal(
            out.detach().numpy().view(np.uint32),
            codec(v.detach()).numpy().view(np.uint32))


@pytest.mark.parametrize("prec,depth", [("f32", False), ("f32", True),
                                        ("mixed", True), ("packed", False)])
def test_binning_gradients_match_jax(prec, depth):
    p_j, cfg_j = _jax_projection(1500, 26, (1.6, 0.9, 1.6), 2.0)
    kw = dict(record_precision=prec, return_depth=depth)
    pairs_j, _, rec_j, slots = _bin_both(p_j, cfg_j, **kw)
    assert int(pairs_j.overflow) == 0 and np.diff(
        np.asarray(pairs_j.tile_counts)).any()
    nd = rec_j.shape[0] - 2                       # rx, ry carry none
    weights = np.random.default_rng(27).normal(
        size=(nd, slots.size)).astype(np.float32)
    names = DIFF_FIELDS if depth else DIFF_FIELDS[:-1]
    cfg_jk = cfg_j.replace(**kw)

    def loss_j(*vals):
        pairs = bin_j.bin_sort_records(
            dataclasses.replace(p_j, **dict(zip(names, vals))), cfg_jk)
        rec = jnp.stack([pairs.xs, pairs.ys, pairs.cas, pairs.cbs, pairs.ccs,
                         pairs.crs, pairs.cgs, pairs.cbs2]
                        + ([pairs.depths] if depth else []) + [pairs.opas])
        return jnp.sum(rec[:, slots] * weights)

    g_j = jax.jit(jax.grad(loss_j, argnums=tuple(range(len(names)))))(
        *(getattr(p_j, f) for f in names))
    proj = _port_projection(p_j)
    for f in names:
        getattr(proj, f).requires_grad_(True)
    cfg_t = gt.RenderConfig(width=cfg_j.width, height=cfg_j.height,
                            sh_degree=cfg_j.sh_degree, **kw)
    rec = bin_t.bin_sort_records(proj, cfg_t).records
    (rec[:nd, slots] * torch.from_numpy(weights)).sum().backward()
    bar = 1e-5 if prec == "f32" else 1e-2
    for f, gj in zip(names, g_j):
        gj = np.asarray(gj)
        scale = np.abs(gj).max()
        assert scale > 0.0, f
        p999, _ = error_mass(getattr(proj, f).grad.numpy() / scale,
                             gj / scale)
        assert p999 <= bar, (f, p999)


def test_sharded_arguments_raise():
    """The slab arguments bin (tests/test_torch_sharded.py holds them to
    the JAX package's); a window that is not whole tile rows, or both
    kinds of window at once, raises."""
    s_t = gt.SplatData.from_numpy(*scene_arrays(100, seed=25), device="cpu")
    cam = gt.Camera.look_at((2.5, 1.5, 2.5), (0, 0, 0), device="cpu")
    cfg = gt.RenderConfig(width=256, height=192)
    proj = proj_t.project_splats(s_t, cam, cfg)
    for kw, tiles in ((dict(tile_range=(0, 8)), 8),
                      (dict(depth_bounds=(0.0, 1.0)), cfg.num_tiles),
                      (dict(row_window=(0, 2, 3)), 24)):
        pairs = bin_t.bin_sort_records(proj, cfg, **kw)
        assert pairs.tile_starts.shape == (tiles,)
    for kw in (dict(tile_range=(4, 8)), dict(tile_range=(0, 12)),
               dict(tile_range=(0, 8), row_window=(0, 2, 3))):
        with pytest.raises(ValueError):
            bin_t.bin_sort_records(proj, cfg, **kw)


# the record gather's backward: slot layouts by the config, the binning's
# window arguments and the scene (zoom: close up on large splats)
GATHER_CASES = {
    "lanes1": dict(cfg=dict(lanes=1)),
    "lanes2": dict(cfg=dict(aux_multiplier=1.5)),
    "lanes4": dict(cfg=dict(lanes=4)),
    "no_aux": dict(cfg=dict(aux_multiplier=0.0)),
    "overflow": dict(zoom=True),
    "aux_capacity": dict(window=dict(aux_capacity=300)),
    "banded": dict(window=dict(tile_range=(16, 32))),
    "strided": dict(window=dict(row_window=(1, 3, 4))),
    "surfel_2d": dict(cfg=dict(render_mode_2d=True, return_depth=True)),
    "forward_only": dict(cfg=dict(forward_only=True,
                                  record_precision="packed")),
    "bit_equal": dict(cfg=dict(aux_multiplier=1.5), repeat=True),
}


@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_gather_bwd_matches_index_add(case, monkeypatch):
    spec = GATHER_CASES[case]
    zoom = spec.get("zoom", False)
    arrays = scene_arrays(1500, sh_degree=1, seed=28,
                          scale_mul=6.0 if zoom else 1.0)
    s_t = gt.SplatData.from_numpy(*arrays, device="cpu")
    cam = gt.Camera.look_at((1.2, 0.7, 1.2) if zoom else (2.5, 1.5, 2.5),
                            (0, 0, 0), fov_y_deg=60, aspect=4 / 3,
                            device="cpu")
    cfg = gt.RenderConfig(width=256, height=192, sh_degree=1, tile_size=16,
                          **spec.get("cfg", {}))
    calls = capture_gathers(monkeypatch)
    window = spec.get("window", {})
    with torch.no_grad():
        if cfg.render_mode_2d:
            recs = surf_t.bin_sort_surfels(
                surf_t.project_surfels(s_t, cam, cfg), cfg, **window)[0]
        else:
            recs = bin_t.bin_sort_records(proj_t.project_splats(s_t, cam, cfg),
                                          cfg, **window).records
    (src, perm, layout), = calls
    n = s_t.num_splats
    assert layout.slots == recs.shape[1] and layout.n == n
    if case == "no_aux":
        assert layout.dest is None
    elif case in ("overflow", "aux_capacity"):
        assert int(layout.covered) > layout.aux_cap       # aux overflows
    else:
        assert 0 < int(layout.covered) < layout.aux_cap
    tail = tail_slots(layout)
    assert tail > 0 or case in ("overflow", "no_aux")

    gen = torch.Generator().manual_seed(29)
    g = torch.randn(recs.shape, generator=gen)
    d, tail_d = bin_t.gather_bwd_torch(g, perm, layout)
    assert d.dtype == torch.float32 and tail_d == tail
    ref, scale = index_add_grad(g, src, n)
    assert bool(((d.double() - ref).abs() <= 1e-6 * scale).all())
    if spec.get("repeat"):
        # two calls, and two backward passes through the gather, bit equal
        again, _ = bin_t.gather_bwd(g, perm, layout)
        assert torch.equal(d.view(torch.int32), again.view(torch.int32))
        x = torch.randn((recs.shape[0], n), generator=gen)
        grads = []
        for _ in range(2):
            a = x.clone().requires_grad_(True)
            bin_t._Gather.apply(a, src, perm, layout).backward(g)
            grads.append(a.grad)
        assert torch.equal(grads[0].view(torch.int32),
                           grads[1].view(torch.int32))
        assert torch.equal(grads[0], d)


def test_gather_bwd_cuda_checks_its_inputs(monkeypatch):
    """The kernel's wrapper raises on what csrc/gather_bwd.cu does not
    take: a cotangent off the layout, more than 32 rows, float64, int32
    indices, CPU tensors."""
    src, perm, layout = random_gather(monkeypatch, 11, 50, seed=33)
    s = layout.slots
    for g, p, match in (
            (torch.zeros((11, s + 1)), perm, "layout"),
            (torch.zeros((33, s)), perm, "layout"),
            (torch.zeros((11, s), dtype=torch.float64), perm, "float32"),
            (torch.zeros((11, s)), perm.int(), "perm"),
            (torch.zeros((11, s)), perm, "CUDA")):
        with pytest.raises(ValueError, match=match):
            bin_t.gather_bwd_cuda(g, p, layout)


@pytest.mark.cuda
@pytest.mark.parametrize("f,lanes,aux", [
    (11, 2, 1.5), (12, 1, 1.5), (17, 4, 1.5), (18, 2, 0.0), (3, 2, 0.05),
], ids=["3d", "3d_depth_lanes1", "2d_lanes4", "2d_depth_no_aux",
        "overflow"])
def test_cuda_gather_bwd_matches_plain_and_index_add(f, lanes, aux,
                                                     cuda_device,
                                                     monkeypatch):
    """csrc/gather_bwd.cu against its plain version and index_add_ for a
    random cotangent over every slot; two calls bit equal."""
    src, perm, layout = random_gather(monkeypatch, f, 20000, seed=30 + f,
                                      device=cuda_device, lanes=lanes,
                                      aux_multiplier=aux)
    if aux == 0.05:
        assert int(layout.covered) > layout.aux_cap
    gen = torch.Generator(cuda_device).manual_seed(31)
    g = torch.randn((f, layout.slots), generator=gen, device=cuda_device)
    d, tail = bin_t.gather_bwd_cuda(g, perm, layout)
    again, _ = bin_t.gather_bwd_cuda(g, perm, layout)
    plain, tail_plain = bin_t.gather_bwd_torch(g, perm, layout)
    torch.cuda.synchronize()
    assert torch.equal(d.view(torch.int32), again.view(torch.int32))
    assert int(tail) == tail_plain == tail_slots(layout)
    ref, scale = index_add_grad(g, src, layout.n)
    for out in (d, plain):
        assert bool(((out.double() - ref).abs() <= 1e-6 * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("f,lanes,aux", [
    (11, 2, 1.5), (17, 4, 1.5), (18, 2, 0.0), (3, 2, 0.05),
], ids=["3d", "2d_lanes4", "2d_depth_no_aux", "overflow"])
def test_cuda_gather_bwd_stays_in_its_buffers(f, lanes, aux, cuda_device,
                                             monkeypatch):
    """csrc/gather_bwd.cu inside guard zones (torch_gather.
    guarded_gather_bwd): every guard as it was, so nothing is written out
    of bounds; no NaN in d, so no row is read before it is written and no
    read passes an edge; d bit equal to the wrapper's."""
    src, perm, layout = random_gather(monkeypatch, f, 20000, seed=40 + f,
                                      device=cuda_device, lanes=lanes,
                                      aux_multiplier=aux)
    gen = torch.Generator(cuda_device).manual_seed(41)
    g = torch.randn((f, layout.slots), generator=gen, device=cuda_device)
    d, tail, intact = guarded_gather_bwd(g, perm, layout)
    want, want_tail = bin_t.gather_bwd_cuda(g, perm, layout)
    torch.cuda.synchronize()
    assert intact
    assert not bool(torch.isnan(d).any())
    assert torch.equal(d.view(torch.int32), want.view(torch.int32))
    assert int(tail) == int(want_tail) == tail_slots(layout)


@pytest.mark.cuda
@pytest.mark.parametrize("mode_2d", [False, True], ids=["3d", "2d"])
def test_cuda_gather_bwd_on_the_compositors_cotangent(mode_2d, cuda_device,
                                                      monkeypatch):
    """The cotangent B2 (B4 in 2D) hands the gather in a render's
    backward: the kernel against index_add_, two calls bit equal."""
    calls = capture_gathers(monkeypatch)
    cots = []
    bwd = bin_t.gather_bwd

    def recording(g, perm, layout):
        cots.append(g)
        return bwd(g, perm, layout)

    monkeypatch.setattr(bin_t, "gather_bwd", recording)
    cfg = gt.RenderConfig(width=320, height=192, sh_degree=1,
                          aux_multiplier=1.5, render_mode_2d=mode_2d)
    cam = gt.Camera.look_at((2.5, 1.5, 2.5), (0, 0, 0), fov_y_deg=60,
                            aspect=320 / 192, device=cuda_device)
    s = gt.SplatData.from_numpy(*scene_arrays(20000, sh_degree=1, seed=32),
                                device=cuda_device)
    for name in ("means", "scales", "quats", "colors", "sh"):
        getattr(s, name).requires_grad_(True)
    (gt.render(s, cam, cfg)["color"] ** 2).mean().backward()
    (src, perm, layout), = calls
    g, = cots
    assert bool((g != 0).any()) and tail_slots(layout) > 0
    d, _ = bin_t.gather_bwd_cuda(g, perm, layout)
    again, _ = bin_t.gather_bwd_cuda(g, perm, layout)
    torch.cuda.synchronize()
    assert torch.equal(d.view(torch.int32), again.view(torch.int32))
    ref, scale = index_add_grad(g, src, layout.n)
    assert bool(((d.double() - ref).abs() <= 1e-6 * scale).all())
