"""The port's spans and counters (utils/metrics.py): off unless a
torch.profiler records, nested as the layers nest inside a render and a
training step (3D and 2D), binning's counters equal to what render()
reports, the kernel launch counters in the same registry, and nothing
that the program computes moved by tracing; the record gather's backward
against index_select's gradient and its ``bin.bwd_tail``.  On the CPU;
the card's test (marked ``cuda``) reads the gather's launches and
kernels inside its span."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gaussiansplats3d_tpu_torch as gt
from gaussiansplats3d_tpu_torch.parallel import train
from gaussiansplats3d_tpu_torch.render import binning, surfel
from gaussiansplats3d_tpu_torch.render.projection import project_splats
from gaussiansplats3d_tpu_torch.utils import metrics

from torch_gather import (capture_gathers, index_add_grad, random_gather,
                          tail_slots)
from torch_port_common import cuda_device  # noqa: F401  (fixture)
from torch_scenes import scene_arrays

torch.set_num_threads(2)

W, H = 64, 48
BIN = ("bin.calls", "bin.slots", "bin.pairs_kept", "bin.dropped",
       "bin.bwd_tail")
FIELDS = ("means", "scales", "quats", "colors", "sh")
MODES = pytest.mark.parametrize("mode_2d", [False, True], ids=["3d", "2d"])


def _scene(n=300, seed=3, scale_mul=1.0):
    return gt.SplatData.from_numpy(
        *scene_arrays(n, sh_degree=1, seed=seed, scale_mul=scale_mul),
        device="cpu")


def _cfg(mode_2d, **kw):
    return gt.RenderConfig(width=W, height=H, sh_degree=1, tile_size=16,
                           render_mode_2d=mode_2d, **kw)


def _cam():
    return gt.Camera.look_at((2.2, 1.4, 2.0), (0, 0, 0), aspect=W / H,
                             device="cpu")


def _step_inputs(mode_2d):
    cfg = _cfg(mode_2d)
    state = train.TrainState.create(_scene(), train.adam(1e-2))
    step = train.make_train_step(cfg, None, train.adam(1e-2))
    target = torch.linspace(0.0, 1.0, H * W * 3).reshape(H, W, 3)
    tiles, mask = train.image_to_tile_blocks(target, cfg)
    return step, state, tiles, mask


def _spans(prof, tmp_path):
    """The gs.* ranges of a profile's Chrome trace: [(name, start, end)]."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith("gs.")]


def _holds(spans, outer, inner):
    """Every ``inner`` span lies inside some ``outer`` span, and there is
    at least one."""
    outs = [(a, b) for n, a, b in spans if n == outer]
    ins = [(a, b) for n, a, b in spans if n == inner]
    return bool(ins) and all(any(a <= c and d <= b for a, b in outs)
                             for c, d in ins)


@pytest.fixture(autouse=True)
def _no_observed():
    metrics.reset(*BIN)
    yield
    metrics.reset(*BIN)


@MODES
def test_off_spans_are_null_and_nothing_is_observed(mode_2d):
    step, state, tiles, mask = _step_inputs(mode_2d)
    step(state, _cam(), tiles, mask)
    gt.render(_scene(), _cam(), _cfg(mode_2d))
    assert metrics.span("gs.render") is metrics.span("gs.bin")
    assert not set(metrics.totals()) & set(BIN)


@MODES
def test_a_profiled_step_and_render_hold_the_spans(mode_2d, tmp_path):
    step, state, tiles, mask = _step_inputs(mode_2d)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert metrics.span("gs.a") is not metrics.span("gs.b")
        step(state, _cam(), tiles, mask)
    sp = _spans(prof, tmp_path)
    for inner in ("gs.project", "gs.bin", "gs.backward"):
        assert _holds(sp, "gs.train.step", inner), inner
    for inner in ("gs.composite.bwd", "gs.bin.gather_bwd"):
        assert _holds(sp, "gs.backward", inner), inner
    assert not any(n == "gs.render" for n, _, _ in sp)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gt.render(_scene(), _cam(), _cfg(mode_2d))
    sp = _spans(prof, tmp_path)
    for inner in ("gs.project", "gs.bin"):
        assert _holds(sp, "gs.render", inner), inner
    assert {n for n, _, _ in sp} == {"gs.render", "gs.project", "gs.bin"}


@MODES
def test_bin_counters_equal_the_render_aux(mode_2d):
    s, cfg = _scene(), _cfg(mode_2d)
    with profile(activities=[ProfilerActivity.CPU]):
        out = gt.render(s, _cam(), cfg, return_aux=True)
    got = metrics.totals()
    lanes, aux, pad = binning.slot_layout_for(cfg, s.num_splats)
    assert got["bin.calls"] == 1
    assert got["bin.slots"] == lanes * s.num_splats + aux + pad
    assert got["bin.pairs_kept"] == int(out["num_pairs"] - out["overflow"])
    assert got["bin.dropped"] == int(out["overflow"]) == 0
    assert got["bin.pairs_kept"] > 0


@MODES
def test_a_small_aux_capacity_counts_dropped_pairs(mode_2d):
    s, cfg = _scene(scale_mul=6.0), _cfg(mode_2d)
    cap = 16
    with torch.no_grad():
        if mode_2d:
            sp = surfel.project_surfels(s, _cam(), cfg)
            with profile(activities=[ProfilerActivity.CPU]):
                _, _, _, total, overflow = surfel.bin_sort_surfels(
                    sp, cfg, aux_capacity=cap)
        else:
            proj = project_splats(s, _cam(), cfg)
            with profile(activities=[ProfilerActivity.CPU]):
                pairs = binning.bin_sort_records(proj, cfg, aux_capacity=cap)
            total, overflow = pairs.total_pairs, pairs.overflow
    got = metrics.totals()
    lanes = cfg.lanes
    n = s.num_splats
    pad = (-(lanes * n + cap)) % binning.CHUNK
    assert got["bin.slots"] == lanes * n + cap + pad
    assert got["bin.dropped"] == int(overflow) > 0
    assert got["bin.pairs_kept"] == int(total - overflow)


@MODES
def test_images_and_gradients_are_bit_equal_under_the_profiler(mode_2d):
    def run():
        s = _scene()
        for f in FIELDS:
            getattr(s, f).requires_grad_(True)
        out = gt.render(s, _cam(), _cfg(mode_2d))
        (out["color"] ** 2).mean().backward()
        return out, {f: getattr(s, f).grad for f in FIELDS}

    out0, g0 = run()
    with profile(activities=[ProfilerActivity.CPU]):
        out1, g1 = run()
    for k in ("color", "alpha"):
        assert torch.equal(out0[k], out1[k]), k
    for f in FIELDS:
        assert torch.equal(g0[f], g1[f]), f


@MODES
def test_profiled_train_steps_are_bit_equal(mode_2d):
    def run(traced):
        step, state, tiles, mask = _step_inputs(mode_2d)
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                _, m = step(state, _cam(), tiles, mask)
        else:
            _, m = step(state, _cam(), tiles, mask)
        return m, list(state.params.parameters())

    (m0, p0), (m1, p1) = run(False), run(True)
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("f,n,lanes", [(11, 7, 2), (17, 300, 4), (3, 1, 1)])
def test_gather_gradients_equal_index_select(f, n, lanes, dtype,
                                             monkeypatch):
    """The gather's backward is the gradient of index_select, to the
    rounding of its sums: |d| <= rtol times the same sums of |cotangent|,
    against autograd's index_add_ in float64.  The unused aux slots and
    the pad all name column 0."""
    src, perm, layout = random_gather(monkeypatch, f, n, seed=f * n + lanes,
                                      lanes=lanes, aux_multiplier=1.5)
    assert tail_slots(layout) > 0 and bool((src == 0).sum() > lanes)
    gen = torch.Generator().manual_seed(f * n)
    x = torch.randn(f, n, generator=gen, dtype=dtype)
    cot = torch.randn(f, layout.slots, generator=gen, dtype=dtype)
    a = x.clone().requires_grad_(True)
    b = x.clone().requires_grad_(True)
    ya = binning._Gather.apply(a, src, perm, layout)
    yb = b.index_select(1, src)
    assert torch.equal(ya, yb)
    ya.backward(cot)
    yb.backward(cot)
    ref, scale = index_add_grad(cot, src, n)
    rtol = 1e-6 if dtype == torch.float32 else 1e-13
    for grad in (a.grad, b.grad):
        assert grad.dtype == dtype
        assert bool(((grad.double() - ref).abs() <= rtol * scale).all())


@MODES
def test_bwd_tail_counts_the_slots_folded_into_splat_0(mode_2d, monkeypatch):
    """A profiled training step observes ``bin.bwd_tail`` = aux_cap -
    min(covered, aux_cap) + pad; the plain backward counts no launch."""
    calls = capture_gathers(monkeypatch)
    step, state, tiles, mask = _step_inputs(mode_2d)
    before = metrics.total(binning.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, _cam(), tiles, mask)
    (_, _, layout), = calls
    kept = min(int(layout.covered), layout.aux_cap)
    got = metrics.totals()
    assert got["bin.bwd_tail"] == layout.aux_cap - kept + layout.pad > 0
    assert metrics.total(binning.LAUNCHES) == before
    metrics.reset("bin.bwd_tail")
    step(state, _cam(), tiles, mask)            # off: nothing observed
    assert "bin.bwd_tail" not in metrics.totals()


@pytest.mark.cuda
@MODES
def test_cuda_gather_bwd_launches_and_span(mode_2d, cuda_device,
                                           monkeypatch, tmp_path):
    """On the card a training step's backward launches the gather's two
    kernels once (``gather_bwd.launches`` 2), observes ``bin.bwd_tail``,
    and the span ``gs.bin.gather_bwd`` holds both kernels' device time."""
    calls = capture_gathers(monkeypatch)
    cfg = _cfg(mode_2d)
    s = gt.SplatData.from_numpy(*scene_arrays(300, sh_degree=1, seed=3),
                                device=cuda_device)
    state = train.TrainState.create(s, train.adam(1e-2))
    step = train.make_train_step(cfg, None, train.adam(1e-2))
    target = torch.linspace(0.0, 1.0, H * W * 3,
                            device=cuda_device).reshape(H, W, 3)
    tiles, mask = train.image_to_tile_blocks(target, cfg)
    cam = gt.Camera.look_at((2.2, 1.4, 2.0), (0, 0, 0), aspect=W / H,
                            device=cuda_device)
    step(state, cam, tiles, mask)               # builds and warms up
    # the first step on a state runs eagerly (the 2D route replays a CUDA
    # graph from its second): the profiled step is a fresh state's first
    state = train.TrainState.create(s, train.adam(1e-2))
    torch.cuda.synchronize()
    calls.clear()
    before = metrics.total(binning.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, cam, tiles, mask)
        torch.cuda.synchronize()
    assert metrics.total(binning.LAUNCHES) - before == 2
    (_, _, layout), = calls
    assert metrics.total("bin.bwd_tail") == tail_slots(layout)
    # the benchmark's attribution (splatbench/spans.py): a kernel belongs
    # to the span that holds its launch call, by the call's correlation
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    span, = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == "gs.bin.gather_bwd"]
    t0, t1 = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    held = {e["args"]["correlation"] for e in events
            if e.get("cat") == "cuda_runtime"
            and e["name"].startswith("cudaLaunchKernel")
            and e["tid"] == span["tid"] and t0 <= float(e["ts"]) <= t1}
    names = {"gather_unsort_kernel", "gather_reduce_kernel"}
    kernels = [e for e in events if e.get("cat") == "kernel"
               and e["name"].split("<")[0].split("::")[-1] in names]
    assert {e["name"].split("<")[0].split("::")[-1]
            for e in kernels} == names and len(kernels) == 2
    assert all(e["args"]["correlation"] in held for e in kernels)
    assert sum(float(e["dur"]) for e in kernels) > 0


def test_registry_adds_observes_and_resets():
    metrics.reset("t.a", "t.b")
    metrics.add("t.a")
    metrics.add("t.a", 2)
    metrics.observe("t.b", 5)           # off: nothing
    assert metrics.total("t.a") == 3 and metrics.total("t.b") == 0
    with profile(activities=[ProfilerActivity.CPU]):
        metrics.observe("t.b", 4)
        metrics.observe("t.b", torch.tensor(6))
        metrics.observe("t.b", torch.tensor(-1))
        with metrics.span("gs.test") as r:
            assert r is not None
    got = metrics.totals()
    assert got["t.a"] == 3 and got["t.b"] == 9
    assert metrics.total("t.b") == 9
    metrics.reset("t.b")
    assert metrics.total("t.b") == 0 and metrics.total("t.a") == 3
    metrics.reset("t.a")
    assert "t.a" not in metrics.totals()


def test_traced_keeps_the_function_and_its_result():
    @metrics.traced("gs.test")
    def f(a, b=2):
        """Doc."""
        return a + b

    assert f(1) == 3 and f(1, b=5) == 6
    assert f.__name__ == "f" and f.__doc__ == "Doc."
    with profile(activities=[ProfilerActivity.CPU]):
        assert f(2) == 4


def test_kernel_reset_clears_its_launch_counters_alone():
    from gaussiansplats3d_tpu_torch.render import cuda_rasterize as cr
    from gaussiansplats3d_tpu_torch.render import cuda_surfel as cs
    before = metrics.total(cs.LAUNCHES)
    metrics.add(cr.LAUNCHES, 3)
    metrics.add(cr.BWD_LAUNCHES)
    metrics.add(cs.LAUNCHES)
    cr.reset_launches()
    assert metrics.total(cr.LAUNCHES) == metrics.total(cr.BWD_LAUNCHES) == 0
    assert metrics.total(cs.LAUNCHES) == before + 1
    cs.reset_launches()
    assert metrics.total(cs.LAUNCHES) == 0
