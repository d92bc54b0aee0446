"""The metric arithmetic on synthetic timings and a synthetic timeline."""

import math
import statistics
from types import SimpleNamespace

from splatbench import harness, layers, work
from splatbench.drivers import train as train_driver
from splatbench.trace import WINDOW, Trace


def _ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}


EVENTS = [
    _ev(WINDOW, "user_annotation", 0.0, 1000.0),
    _ev("aten::sort", "cpu_op", 380.0, 250.0),
    _ev("aten::index_add_", "cpu_op", 690.0, 300.0),
    _ev("void composite_fwd_kernel<1>(float const*)", "kernel", 100.0, 200.0),
    _ev("radixSort", "kernel", 250.0, 150.0),
    _ev("void composite_fwd_kernel<1>(float const*)", "kernel", 600.0, 100.0),
    _ev("Memcpy HtoD", "gpu_memcpy", 650.0, 10.0),
]


def test_trace_busy_window_and_gaps():
    tr = Trace(EVENTS)
    assert math.isclose(tr.window_s, 1e-3)
    assert math.isclose(tr.busy_s, 400e-6)
    gaps = tr.idle_gaps()
    assert [g[0] for g in gaps] == ["aten::index_add_", "aten::sort",
                                    "no host event"]
    assert math.isclose(gaps[0][1], 300e-6)
    assert math.isclose(sum(g[1] for g in gaps), 600e-6)
    durs = tr.kernel_durations(("composite_fwd_kernel",))
    assert [round(d * 1e6) for d in durs] == [200, 100]
    top = tr.top_ops()
    assert top[0][0].startswith("void composite_fwd") and \
        math.isclose(top[0][1], 300e-6)
    probe = SimpleNamespace(kind="orbit", trace=tr)
    assert math.isclose(layers.device_idle(probe, "orbit"), 60.0)
    assert layers.device_idle(probe, "train") is None


def test_roofline_divides_the_bound_by_the_kernel_time():
    tr = Trace(EVENTS)
    run = SimpleNamespace(traced_views=[3, 5])
    probe = layers.Probe.__new__(layers.Probe)
    probe.run, probe.trace, probe.kind = run, tr, "orbit"
    ops, nbytes = 67e12 * 1e-6, 3.35e12 * 0.5e-6      # 1 us of ops
    probe.work_of = lambda view, fn: (ops, nbytes)
    v = layers.roofline(probe, "orbit", ("composite_fwd_kernel",), None)
    # 2 calls x 1 us of bound over 300 us of kernel time
    assert math.isclose(v, 100.0 * 2e-6 / 300e-6)
    assert layers.roofline(probe, "orbit", ("nothing",), None) is None
    assert work.bound_of(ops, nbytes)[1] == "operations"


def test_percentile_compare_and_worst():
    vals = list(range(1, 201))
    assert harness.quantile(vals, 95) == statistics.quantiles(vals, n=100)[94]
    ok, cmp = harness.compare({"a": 1.0, "b": float("nan")},
                              {"a": 2.0, "b": 1.0})
    assert not ok and cmp["a"] == {"value": 1.0, "limit": 2.0}
    assert cmp["b"]["value"] is None
    ok, _ = harness.compare({"a": 1.0}, {"a": 2.0, "c": 1.0})
    assert not ok
    assert harness.worst(1.0, float("nan"), 3.0) == math.inf
    assert harness.worst(1.0, 3.0) == 3.0


def test_training_gaps_by_the_worst_field():
    ref = {"losses": [1.0, 0.9, 0.8],
           "grad_norms": {"a": 1.0, "b": 2.0, "c": 1e-9, "d": 4.0},
           "change_norms": {"a": 0.5, "b": 0.5, "c": 0.5, "d": 0.5}}
    got = train_driver.gaps(
        [1.001, 0.9, 0.8], {"a": 1.1, "b": 2.0, "c": 0.0, "d": 4.0},
        {"a": 0.5, "b": 0.6, "c": 5.0, "d": 0.5}, ref)
    assert math.isclose(got["loss_gap"], 1e-3, rel_tol=1e-6)
    # field a: 0.1 against max(1.0, the median 2.0)
    assert math.isclose(got["grad_gap"], 0.05)
    # c's reference gradient is round-off: it is left out of the change
    assert math.isclose(got["change_gap"], 0.2)


def test_work_counts_scale_with_the_work():
    assert work.projection_ops(10, 2, False, True) == \
        3 * work.projection_ops(10, 2, False, False)
    assert work.projection_ops(10, 0, False, False) < \
        work.projection_ops(10, 2, False, False)
