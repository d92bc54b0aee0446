"""The program's own spans and counters in a traced window, for the readers
of ``metrics/`` that measure a layer inside the real step or frame.

The program names its layers with ``gs.*`` ranges of ``torch.profiler``
(``gs.render``, ``gs.train.step``, ``gs.project``, ``gs.bin``,
``gs.backward``, ``gs.composite.bwd``, ``gs.bin.gather_bwd``) and counts
binning's slots and pairs while a profiler records (its
``utils.metrics`` registry).  A program without them gives no span and no
counter, and every function here then returns None.

A device event belongs to the runtime call that launched it (the same
``correlation`` arg).  It is put down to the innermost ``gs.*`` span that
holds the launch on the launch's thread; failing that, to the innermost
``gs.*`` span on any thread that holds the launch in time (the backward's
kernels launch from autograd's device thread, inside the main thread's
``gs.backward``).  A span's device ms count its own events and those of
every span it holds in time; its self ms, its own alone.
"""

from __future__ import annotations

import importlib

PREFIX = "gs."
TOP = {"train": "gs.train.step", "orbit": "gs.render"}
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")


def _corr(e):
    return (e.get("args") or {}).get("correlation")


def _end(e) -> float:
    return float(e["ts"]) + float(e["dur"])


class Spans:
    """The ``gs.*`` spans of a ``trace.Trace`` with the device time and
    launch calls put down to each."""

    def __init__(self, trace):
        self.spans = sorted(
            (e for e in trace.host if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(PREFIX)),
            key=lambda e: float(e["ts"]))
        calls = [e for e in trace.host if e.get("cat") in LAUNCH_CATS]
        by_corr = {_corr(e): e for e in calls if _corr(e) is not None}
        self.launches = _outermost([e for e in calls
                                    if e["name"].startswith(LAUNCHES)])
        self.own_us = [0.0] * len(self.spans)
        self.device_us = 0.0
        for d in trace.device:
            dur = float(d["dur"])
            self.device_us += dur
            call = by_corr.get(_corr(d))
            if call is not None:
                i = self._owner(call)
                if i is not None:
                    self.own_us[i] += dur

    def _innermost(self, t: float, tid=None):
        best = None
        for i, s in enumerate(self.spans):
            if float(s["ts"]) > t:
                break
            if t <= _end(s) and (tid is None or s.get("tid") == tid) and (
                    best is None or float(s["dur"])
                    < float(self.spans[best]["dur"])):
                best = i
        return best

    def _owner(self, call):
        t = float(call["ts"])
        i = self._innermost(t, call.get("tid"))
        return i if i is not None else self._innermost(t)

    def _held(self, i: int) -> list:
        """Indices of span ``i`` and of every span it holds in time."""
        s = self.spans[i]
        return [j for j, o in enumerate(self.spans)
                if float(o["ts"]) >= float(s["ts"]) and _end(o) <= _end(s)]

    def named(self, name: str) -> list:
        return [i for i, s in enumerate(self.spans) if s["name"] == name]

    def count(self, name: str) -> int:
        return len(self.named(name))

    def device_ms(self, name: str) -> float:
        """Device ms under every ``name`` span, its held spans' included."""
        held = {j for i in self.named(name) for j in self._held(i)}
        return sum(self.own_us[j] for j in held) * 1e-3

    def self_ms(self, name: str) -> float:
        """Device ms put down to the ``name`` spans themselves."""
        return sum(self.own_us[i] for i in self.named(name)) * 1e-3

    def host_ms(self, name: str) -> float:
        return sum(float(self.spans[i]["dur"]) for i in self.named(name)) \
            * 1e-3

    def launch_calls(self, name: str) -> int:
        """Kernel launch calls, on any thread, inside a ``name`` span."""
        ranges = [(float(self.spans[i]["ts"]), _end(self.spans[i]))
                  for i in self.named(name)]
        return sum(1 for e in self.launches
                   if any(a <= float(e["ts"]) <= b for a, b in ranges))

    def share_under(self, name: str) -> float:
        """Percent of the window's device time put down to ``name`` spans."""
        if self.device_us <= 0.0:
            return 0.0
        return 100.0 * self.device_ms(name) * 1e3 / self.device_us


def _outermost(events: list) -> list:
    """The launch calls that no other launch call on their thread holds
    (a runtime launch may show its driver call inside it)."""
    out = []
    for e in sorted(events, key=lambda e: (str(e.get("tid")),
                                           float(e["ts"]))):
        if out and out[-1].get("tid") == e.get("tid") and \
                _end(e) <= _end(out[-1]):
            continue
        out.append(e)
    return out


def of(probe):
    """The probe's spans, or None off the card, for another kind of cell,
    or where the window holds no top span of the cell's kind."""
    top = TOP.get(probe.kind)
    if not probe.on_card or top is None:
        return None
    sp = Spans(probe.trace)
    return sp if sp.count(top) else None


def ms_per_call(probe, kind: str, under=(), self_of=()):
    """Device ms a step or frame: the sum of ``device_ms`` of the spans in
    ``under`` and ``self_ms`` of those in ``self_of``, over the window's
    top spans; None where any of those spans is missing."""
    if probe.kind != kind:
        return None
    sp = of(probe)
    if sp is None or not all(sp.count(n) for n in (*under, *self_of)):
        return None
    ms = (sum(sp.device_ms(n) for n in under)
          + sum(sp.self_ms(n) for n in self_of))
    return ms / sp.count(TOP[kind])


def host_ms_per_call(probe, kind: str):
    """Host ms a step or frame inside its top span: the enqueue."""
    if probe.kind != kind:
        return None
    sp = of(probe)
    return None if sp is None else sp.host_ms(TOP[kind]) / sp.count(TOP[kind])


def launches_per_call(probe, kind: str):
    """Kernel launch calls a step or frame inside its top span."""
    if probe.kind != kind:
        return None
    sp = of(probe)
    if sp is None or not sp.launches:
        return None
    return sp.launch_calls(TOP[kind]) / sp.count(TOP[kind])


def counters(probe, kind: str):
    """The program's counter totals of the window (its ``utils.metrics``
    registry), or None where the program has none or counted no binning.
    Only a profiled window observes, so the readers' own calls after it
    add nothing; nothing here resets the registry."""
    if probe.kind != kind or not probe.on_card:
        return None
    try:
        mod = importlib.import_module(probe.run.gt.__name__
                                      + ".utils.metrics")
    except ImportError:
        return None
    totals = getattr(mod, "totals", None)
    if totals is None:
        return None
    got = totals()
    return got if got.get("bin.calls") else None


def slot_fill(probe, kind: str):
    """Percent of binning's pair slots that hold a kept pair."""
    c = counters(probe, kind)
    if c is None or not c.get("bin.slots"):
        return None
    return 100.0 * c.get("bin.pairs_kept", 0) / c["bin.slots"]


def dropped_pairs(probe, kind: str):
    """Aux pairs dropped a binning call (over its aux capacity)."""
    c = counters(probe, kind)
    return None if c is None else c.get("bin.dropped", 0) / c["bin.calls"]
