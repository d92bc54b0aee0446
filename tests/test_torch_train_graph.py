"""The single-device training step's CUDA graph (parallel/train.py,
``_StepGraph``) and the registry's capture recording (utils/metrics.py,
``recording``).

On the CPU: a step never captures and counts ``train.graph.eager``, the
losses of successive steps are distinct tensors, the step's results are
the eager step's to the bit, and a recording counts nothing until it is
replayed.  On the card (marked ``cuda``): six graphed 2D steps against six
eager ones, a capture again on a new state or optimizer, the launch and
binning counters per replay as per eager step, and a traced window of
replays holding B3 and B4 once a step."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gaussiansplats3d_tpu_torch as gt
from gaussiansplats3d_tpu_torch.parallel import heuristics, train
from gaussiansplats3d_tpu_torch.render import binning
from gaussiansplats3d_tpu_torch.render import cuda_surfel as cs
from gaussiansplats3d_tpu_torch.render.pipeline import render_tiles
from gaussiansplats3d_tpu_torch.utils import metrics

from torch_port_common import cuda_device  # noqa: F401  (fixture)
from torch_scenes import scene_arrays

torch.set_num_threads(2)

W, H = 64, 48
GRAPH = ("train.graph.replays", "train.graph.captures", "train.graph.eager")
BIN = ("bin.calls", "bin.slots", "bin.pairs_kept", "bin.dropped",
       "bin.bwd_tail")
LAUNCHES = (cs.LAUNCHES, cs.BWD_LAUNCHES, binning.LAUNCHES)
MODES = pytest.mark.parametrize("mode_2d", [False, True], ids=["3d", "2d"])


@pytest.fixture(autouse=True)
def _no_observed():
    metrics.reset(*GRAPH, *BIN, "t.r")
    yield
    metrics.reset(*GRAPH, *BIN, "t.r")


def _cfg(mode_2d):
    return gt.RenderConfig(width=W, height=H, sh_degree=1, tile_size=16,
                           render_mode_2d=mode_2d)


def _scene(device, n=300, seed=3):
    return gt.SplatData.from_numpy(*scene_arrays(n, sh_degree=1, seed=seed),
                                   device=device)


def _views(cfg, device, k=6):
    """``k`` cameras around the scene, each with its own target blocks."""
    out = []
    for i in range(k):
        a = 0.7 * i
        cam = gt.Camera.look_at((2.4 * float(torch.tensor(a).cos()), 1.4,
                                 2.4 * float(torch.tensor(a).sin())),
                                (0, 0, 0), aspect=W / H, device=device)
        target = torch.linspace(0.1 * i, 1.0, H * W * 3,
                                device=device).reshape(H, W, 3)
        out.append((cam, *train.image_to_tile_blocks(target, cfg)))
    return out


def _graph_counts():
    got = metrics.totals()
    return tuple(got.get(n, 0) for n in GRAPH)


@MODES
def test_cpu_step_never_captures_and_counts_eager(mode_2d):
    cfg = _cfg(mode_2d)
    state = train.TrainState.create(_scene("cpu"), train.adam(1e-2))
    step = train.make_train_step(cfg, None, train.adam(1e-2))
    views = _views(cfg, "cpu", 3)
    step(state, *views[0])                 # untraced: nothing observed
    assert _graph_counts() == (0, 0, 0)
    with profile(activities=[ProfilerActivity.CPU]):
        for v in views:
            step(state, *v)
    assert _graph_counts() == (0, 0, 3)
    assert state.step == 4


@MODES
def test_steps_return_distinct_loss_tensors(mode_2d):
    cfg = _cfg(mode_2d)
    state = train.TrainState.create(_scene("cpu"), train.adam(1e-2))
    step = train.make_train_step(cfg, None, train.adam(1e-2))
    v = _views(cfg, "cpu", 1)[0]
    ms = [step(state, *v)[1] for _ in range(3)]
    losses = [float(m["loss"]) for m in ms]
    stacked = torch.stack([m["loss"] for m in ms])
    assert stacked.tolist() == pytest.approx(losses, rel=0, abs=0)
    assert len({m["loss"].data_ptr() for m in ms}) == 3
    assert len({m["grad_norm"].data_ptr() for m in ms}) == 3
    assert losses[2] < losses[0]


@MODES
def test_cpu_step_is_the_eager_step_to_the_bit(mode_2d):
    """make_train_step on the CPU: render_tiles, the masked loss, the
    backward, the global gradient norm and adam(lr), as written out here."""
    cfg = _cfg(mode_2d)
    views = _views(cfg, "cpu", 3)
    state = train.TrainState.create(_scene("cpu"), train.adam(1e-2))
    step = train.make_train_step(cfg, None, train.adam(1e-2))
    params = train.SplatParams.from_splats(_scene("cpu"))
    opt = train.adam(1e-2)(params.parameters())
    for v in views:
        _, m = step(state, *v)
        cam, tiles, mask = v
        opt.zero_grad(set_to_none=True)
        chans, _, _ = render_tiles(params.to_splats(), cam, cfg)
        loss = train.tile_loss(chans, tiles, mask, cfg)
        loss.backward()
        norm = torch.sqrt(sum((g * g).sum() for g in train._grads(params)))
        opt.step()
        assert torch.equal(m["loss"], loss.detach())
        assert torch.equal(m["grad_norm"], norm)
    for a, b in zip(state.params.parameters(), params.parameters()):
        assert torch.equal(a, b)


def test_recording_counts_nothing_until_replayed():
    before = metrics.total("t.a")
    v = torch.tensor(5)
    with metrics.recording() as rec:
        metrics.add("t.a", 2)
        metrics.observe("t.r", 1)
        metrics.observe("t.r", v)
    assert metrics.total("t.a") == before and metrics.total("t.r") == 0
    rec.replay()                           # untraced: the adds alone
    assert metrics.total("t.a") == before + 2
    assert metrics.total("t.r") == 0
    with profile(activities=[ProfilerActivity.CPU]):
        rec.replay()
        v.fill_(7)                         # the next replay's value
        rec.replay()
    assert metrics.total("t.a") == before + 6
    assert metrics.total("t.r") == (1 + 5) + (1 + 7)
    metrics.reset("t.a")


# --- the card ---------------------------------------------------------------

def _cuda_state(device, lr=1e-2, seed=3):
    return train.TrainState.create(_scene(device, seed=seed),
                                   train.adam(lr))


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


@pytest.mark.cuda
def test_cuda_graphed_2d_steps_match_eager_steps(cuda_device):
    """Six 2D steps through make_train_step (eager, capture, then
    replays) against six of the same inner step run eagerly, its
    optimizer given the capturable form after the first step as the
    graph's is: losses, gradient norms, parameters and Adam's moments
    within 1e-6 relative; bit-equal wherever they are."""
    cfg = _cfg(True)
    views = _views(cfg, cuda_device)
    state = _cuda_state(cuda_device)
    step = train.make_train_step(cfg, None, train.adam(1e-2))
    ref = _cuda_state(cuda_device)
    eager = train._eager_step(cfg, train.adam(1e-2))
    unequal = []
    with profile(activities=[ProfilerActivity.CPU]):
        for k, v in enumerate(views):
            _, m = step(state, *v)
            if k == 1:
                train._make_capturable(ref.opt_state)
            loss, norm = eager(ref, *v)
            for what, x, y in (("loss", m["loss"], loss),
                               ("grad_norm", m["grad_norm"], norm)):
                assert _rel(x, y) <= 1e-6, (k, what)
                if not torch.equal(x, y):
                    unequal.append((k, what))
    assert _graph_counts() == (5, 1, 1)
    for (name, a), b in zip(state.params.named_parameters(),
                            ref.params.parameters()):
        sa, sb = state.opt_state.state[a], ref.opt_state.state[b]
        for what, x, y in (("param", a, b),
                           ("exp_avg", sa["exp_avg"], sb["exp_avg"]),
                           ("exp_avg_sq", sa["exp_avg_sq"],
                            sb["exp_avg_sq"])):
            assert _rel(x, y) <= 1e-6, (name, what)
            if not torch.equal(x, y):
                unequal.append((name, what))
        assert float(sa["step"]) == float(sb["step"]) == 6.0
    assert not unequal, unequal


@pytest.mark.cuda
def test_cuda_step_captures_again_on_a_new_state(cuda_device):
    """A new SplatParams from densify_and_prune, a new optimizer and
    ``opt_state = None`` each run one eager step, then capture again; a
    new camera or target only replays."""
    cfg = _cfg(True)
    views = _views(cfg, cuda_device)
    state = _cuda_state(cuda_device)
    step = train.make_train_step(cfg, None, train.adam(1e-2))

    def three(st):
        return [float(step(st, *v)[1]["loss"]) for v in views[:3]]

    with profile(activities=[ProfilerActivity.CPU]):
        three(state)
        assert _graph_counts() == (2, 1, 1)
        ds = heuristics.DensifyState.create(state.params.num_splats,
                                            cuda_device)
        ds = ds.update(torch.ones((state.params.num_splats, 3),
                                  device=cuda_device))
        params, _ = heuristics.densify_and_prune(
            state.params, ds, torch.Generator(cuda_device).manual_seed(0),
            heuristics.DensifyConfig(grad_threshold=0.0))
        state = train.TrainState(params=params, opt_state=None,
                                 step=state.step)
        three(state)
        assert _graph_counts() == (4, 2, 2)
        state.opt_state = train.adam(1e-2)(state.params.parameters())
        three(state)
        assert _graph_counts() == (6, 3, 3)
        state.opt_state = None
        losses = three(state)
        assert _graph_counts() == (8, 4, 4)
    assert all(torch.isfinite(torch.tensor(losses)))
    assert state.step == 12


@pytest.mark.cuda
def test_cuda_replays_count_launches_and_bins_as_eager_steps(cuda_device):
    """At lr 1e-9 every step bins the same pairs: each replay adds one
    B3, one B4 and the gather's two launches, and, while traced, observes
    the binning counters of the eager step to the pair."""
    cfg = _cfg(True)
    v = _views(cfg, cuda_device, 1)[0]
    state = _cuda_state(cuda_device, lr=1e-9)
    step = train.make_train_step(cfg, None, train.adam(1e-9))
    per_step = []
    for k in range(4):
        before = [metrics.total(n) for n in LAUNCHES]
        with profile(activities=[ProfilerActivity.CPU]):
            step(state, *v)
        torch.cuda.synchronize()
        got = metrics.totals()
        per_step.append(tuple(got.get(n, 0) for n in BIN))
        assert [metrics.total(n) - b
                for n, b in zip(LAUNCHES, before)] == [1, 1, 2], k
        metrics.reset(*BIN)
    assert per_step[0][0] == 1 and per_step[0][1] > 0
    assert per_step[1:] == [per_step[0]] * 3
    assert _graph_counts() == (3, 1, 1)


@pytest.mark.cuda
def test_cuda_traced_replays_hold_b3_and_b4_once_a_step(cuda_device):
    cfg = _cfg(True)
    views = _views(cfg, cuda_device)
    state = _cuda_state(cuda_device)
    step = train.make_train_step(cfg, None, train.adam(1e-2))
    for v in views[:2]:                    # eager, then the capture
        step(state, *v)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for v in views[2:]:
            step(state, *v)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("surfel_fwd_kernel" in n for n in names) == 4
    assert sum("surfel_bwd_kernel" in n for n in names) == 4
    assert _graph_counts() == (4, 0, 0)
