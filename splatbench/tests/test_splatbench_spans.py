"""The program's spans and counters read from a synthetic timeline: two
threads (the step's, and autograd's device thread that launches the
backward), launches matched to kernels by ``correlation``, and readers
that return None where the program gives nothing to read."""

import math
import sys
import types
from types import SimpleNamespace

import pytest

from splatbench import harness, spans
from splatbench.trace import WINDOW, Trace

MAIN, AUTOGRAD = 11, 12


def _ev(name, cat, ts, dur, tid=MAIN, corr=None):
    e = {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr, tid=MAIN, kernel_ts=None, kernel_dur=10.0,
            name="cudaLaunchKernel"):
    """A launch call and the kernel it launched (on the device's clock)."""
    return [_ev(name, "cuda_runtime", ts, 2.0, tid, corr),
            _ev(f"kernel_{corr}", "kernel", kernel_ts or ts + 5.0,
                kernel_dur, 7, corr)]


def _step(t0, c0):
    """One training step at ``t0`` (us): the step's spans on the main
    thread, the backward's on autograd's, and seven launches."""
    ev = [_ev("gs.train.step", "user_annotation", t0, 600.0),
          _ev("gs.project", "user_annotation", t0 + 10, 90.0),
          _ev("gs.bin", "user_annotation", t0 + 100, 100.0),
          _ev("gs.backward", "user_annotation", t0 + 250, 300.0),
          _ev("gs.composite.bwd", "user_annotation", t0 + 260, 40.0,
              AUTOGRAD),
          _ev("gs.bin.gather_bwd", "user_annotation", t0 + 400, 50.0,
              AUTOGRAD)]
    ev += _launch(t0 + 20, c0, kernel_dur=30.0)             # projection
    # the driver call inside a runtime launch: one launch, not two
    ev.append(_ev("cuLaunchKernel", "cuda_driver", t0 + 20.5, 1.0))
    ev += _launch(t0 + 150, c0 + 1, kernel_dur=50.0)        # binning
    ev += _launch(t0 + 270, c0 + 2, AUTOGRAD, kernel_dur=40.0)   # B2
    ev += _launch(t0 + 410, c0 + 3, AUTOGRAD, kernel_dur=100.0)  # gather
    # the projection's backward: autograd's thread, outside its spans
    ev += _launch(t0 + 350, c0 + 4, AUTOGRAD, kernel_dur=20.0)
    ev += _launch(t0 + 560, c0 + 5, kernel_dur=10.0,
                  name="cudaLaunchKernelExC")              # Adam
    ev += _launch(t0 + 700, c0 + 6, kernel_dur=5.0)         # no span
    ev.append(_ev("aten::mul", "cpu_op", t0 + 19, 5.0))
    return ev


EVENTS = ([_ev(WINDOW, "user_annotation", 0.0, 2000.0)]
          + _step(0.0, 100) + _step(1000.0, 200))


def _probe(events=EVENTS, kind="train", on_card=True, gt_name="prog"):
    return SimpleNamespace(kind=kind, on_card=on_card, trace=Trace(events),
                           run=SimpleNamespace(gt=SimpleNamespace(
                               __name__=gt_name)))


def test_device_time_goes_to_the_innermost_span_of_the_launch():
    sp = spans.Spans(Trace(EVENTS))
    assert sp.count("gs.train.step") == 2
    # launched on autograd's thread inside its own span
    assert math.isclose(sp.device_ms("gs.bin.gather_bwd"), 2 * 0.100)
    assert math.isclose(sp.device_ms("gs.composite.bwd"), 2 * 0.040)
    # outside autograd's spans: by time, to the main thread's gs.backward
    assert math.isclose(sp.self_ms("gs.backward"), 2 * 0.020)
    assert math.isclose(sp.device_ms("gs.backward"), 2 * 0.160)
    assert math.isclose(sp.device_ms("gs.project"), 2 * 0.030)
    assert math.isclose(sp.self_ms("gs.train.step"), 2 * 0.010)
    assert math.isclose(sp.device_ms("gs.train.step"), 2 * 0.250)
    assert math.isclose(sp.share_under("gs.train.step"), 100 * 250 / 255)


def test_host_ms_and_launches_of_the_top_span():
    sp = spans.Spans(Trace(EVENTS))
    assert math.isclose(sp.host_ms("gs.train.step"), 2 * 0.600)
    # six launches a step inside it, the nested driver call not counted
    assert sp.launch_calls("gs.train.step") == 12
    probe = _probe()
    assert math.isclose(spans.host_ms_per_call(probe, "train"), 0.600)
    assert spans.launches_per_call(probe, "train") == 6


@pytest.mark.parametrize("metric,want", [
    ("gather_bwd_ms.train", 0.100),
    ("gather_bwd_ms.train.2d", 0.100),
    ("projection_step_ms.train", 0.030 + 0.020),
    ("host_ms.train.2d", 0.600),
    ("launches.train.2d", 6),
])
def test_train_readers_read_a_step(metric, want):
    assert math.isclose(harness.reader(metric).read(_probe()), want)


def _frames():
    ev = [_ev(WINDOW, "user_annotation", 0.0, 1000.0)]
    for k, t0 in enumerate((0.0, 500.0)):
        ev += [_ev("gs.render", "user_annotation", t0, 300.0),
               _ev("gs.project", "user_annotation", t0 + 10, 90.0),
               _ev("gs.bin", "user_annotation", t0 + 100, 100.0)]
        ev += _launch(t0 + 20, 10 * k + 1, kernel_dur=30.0)
        ev += _launch(t0 + 150, 10 * k + 2, kernel_dur=50.0)
        ev += _launch(t0 + 250, 10 * k + 3, kernel_dur=8.0)
    return ev


@pytest.mark.parametrize("metric,want", [
    ("projection_step_ms.orbit", 0.030),
    ("binning_step_ms.orbit", 0.050),
    ("host_ms.orbit.2d", 0.300),
    ("launches.orbit.2d", 3),
])
def test_orbit_readers_read_a_frame(metric, want):
    probe = _probe(_frames(), kind="orbit")
    assert math.isclose(harness.reader(metric).read(probe), want)


@pytest.mark.parametrize("metric", [
    "gather_bwd_ms.train", "projection_step_ms.train", "host_ms.train.2d",
    "launches.train.2d", "slot_fill.train", "dropped_pairs.train"])
def test_readers_find_nothing_without_the_programs_spans(metric):
    bare = [e for e in EVENTS if not e["name"].startswith("gs.")]
    assert harness.reader(metric).read(_probe(bare, gt_name="noprog")) \
        is None
    # a CPU run, and a cell of the other kind, read nothing either
    assert harness.reader(metric).read(_probe(on_card=False)) is None
    assert harness.reader(metric).read(_probe(kind="orbit")) is None


def test_a_missing_inner_span_reads_none():
    no_gather = [e for e in EVENTS if e["name"] != "gs.bin.gather_bwd"]
    assert harness.reader("gather_bwd_ms.train").read(
        _probe(no_gather)) is None
    assert harness.reader("projection_step_ms.train").read(
        _probe(no_gather)) is not None


def test_counters_read_the_programs_registry(monkeypatch):
    reg = types.ModuleType("prog.utils.metrics")
    reg.totals = lambda: {"bin.calls": 4, "bin.slots": 1000,
                          "bin.pairs_kept": 250, "bin.dropped": 6,
                          "b1.launches": 9}
    monkeypatch.setitem(sys.modules, "prog.utils.metrics", reg)
    probe = _probe()
    assert math.isclose(harness.reader("slot_fill.train").read(probe), 25.0)
    assert math.isclose(harness.reader("dropped_pairs.train").read(probe),
                        1.5)
    orbit = _probe(kind="orbit")
    assert math.isclose(harness.reader("slot_fill.orbit").read(orbit), 25.0)
    # a registry without totals (an older program), or with no binning
    monkeypatch.delattr(reg, "totals")
    assert harness.reader("slot_fill.train").read(probe) is None
    reg.totals = lambda: {"b1.launches": 9}
    assert harness.reader("dropped_pairs.train").read(probe) is None
