"""Per-frame / per-step metrics and profiling hooks (counterpart of the JAX
package's ``utils/metrics.py``).

The reference surfaces live stats in its InfoPanel (FPS, rendered/total
splat counts, last sort time — the reference's src/ui/InfoPanel.js,
Viewer.js:1804-1822) and ad-hoc performance.now() spans around the sort
(SortWorker.js:33-78).  The port's equivalents:

- :class:`FrameStats` — one render/train step's numbers (wall ms,
  splats, pairs, overflow, Msplats/s).
- :class:`Timer` — wall-clock span that waits for the device at exit
  (``torch.cuda.synchronize()`` when the tensor it was handed lives on a
  CUDA device).
- :func:`profile_trace` — context manager around ``torch.profiler`` that
  writes a Chrome trace (chrome://tracing, Perfetto) into ``logdir``.
- :func:`span` (and the decorator :func:`traced`) — a named range of the render or the training step in that
  trace (``gs.render``, ``gs.train.step``, ``gs.project``, ``gs.bin``,
  ``gs.backward``, ``gs.composite.bwd``, ``gs.bin.gather_bwd``, and the
  mesh's ``gs.exchange``, ``gs.exchange.bwd``, ``gs.allreduce``); a shared
  null context unless a ``torch.profiler`` records (:func:`tracing`).
- The counter registry: :func:`add` (always on, a Python int: the kernel
  wrappers' launches, ``b1.launches`` ... ``b5.launches``,
  ``gather_bwd.launches``), :func:`observe` (only while a profiler
  records: binning's ``bin.calls``, ``bin.slots``, ``bin.pairs_kept``,
  ``bin.dropped``, the record gather's backward's ``bin.bwd_tail``, and
  the mesh exchange's ``exchange.calls``, ``exchange.kept``,
  ``exchange.slots``, ``exchange.dropped``, and the training step's CUDA
  graph's ``train.graph.replays``, ``train.graph.captures``,
  ``train.graph.eager``), :func:`total`, :func:`totals` and
  :func:`reset`.
- :func:`recording` — what a call counts while it is captured into a CUDA
  graph, kept to be counted again at each replay (:class:`Recording`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time
from typing import Optional

import torch

_NULL_SPAN = contextlib.nullcontext()
# name -> a Python int (add) or the values observed while tracing (a list
# of ints and 0-d device tensors, summed when read)
_counters: dict = {}
# the Recording that add and observe write to while a call is captured
_recording = None


def tracing() -> bool:
    """True while a ``torch.profiler`` records."""
    return torch._C._autograd._profiler_enabled()


def span(name: str):
    """``record_function(name)`` while a profiler records (on any thread,
    autograd's backward included), else one shared null context: off, a
    span allocates nothing and launches nothing."""
    if tracing():
        return torch.profiler.record_function(name)
    return _NULL_SPAN


def traced(name: str):
    """Decorator: the function's every call runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def add(name: str, n: int = 1) -> None:
    """Add ``n`` to an always-on counter."""
    if _recording is not None:
        _recording.added[name] = _recording.added.get(name, 0) + n
        return
    _counters[name] = _counters.get(name, 0) + n


def observe(name: str, value) -> None:
    """Record a Python int or a 0-d integer tensor under ``name`` while a
    profiler records; nothing otherwise.  A tensor is kept as it is (no
    read of the device, no kernel) until :func:`totals`."""
    if _recording is not None:
        _recording.observed.append((name, value))
    elif tracing():
        _counters.setdefault(name, []).append(value)


class Recording:
    """What one call counted while it was captured into a CUDA graph: its
    adds, and every value it observed, a profiler recording or not.  A
    capture runs no kernel, so nothing of it is counted then; each replay
    of the graph counts it again (:meth:`replay`)."""

    def __init__(self):
        self.added: dict = {}
        self.observed: list = []

    def replay(self) -> None:
        """Count a replay of the graph, after it is enqueued: the adds, and
        while a profiler records the observed values, the tensors among
        them copied out of the graph's buffers (which the next replay
        overwrites) by one stack."""
        for name, n in self.added.items():
            add(name, n)
        if not tracing():
            return
        tensors = [v for _, v in self.observed if isinstance(v, torch.Tensor)]
        fresh = iter(torch.stack(tensors).unbind(0) if tensors else ())
        for name, v in self.observed:
            observe(name, next(fresh) if isinstance(v, torch.Tensor) else v)


@contextlib.contextmanager
def recording():
    """Within: :func:`add` and :func:`observe` write to the
    :class:`Recording` yielded, and count nothing."""
    global _recording
    _recording = Recording()
    try:
        yield _recording
    finally:
        _recording = None


def totals() -> dict:
    """Every counter's total, as Python ints; the observed tensors are
    summed on the host after one read of the device."""
    tensors = [v for vals in _counters.values() if isinstance(vals, list)
               for v in vals if isinstance(v, torch.Tensor)]
    read = iter(torch.stack(tensors).tolist() if tensors else [])
    out = {}
    for name, vals in _counters.items():
        if isinstance(vals, list):
            vals = sum(next(read) if isinstance(v, torch.Tensor) else v
                       for v in vals)
        out[name] = int(vals)
    return out


def total(name: str) -> int:
    """One counter's total (0 if nothing was counted)."""
    return totals().get(name, 0)


def reset(*names: str) -> None:
    """Clear the named counters, or every counter when none is named."""
    for name in names or list(_counters):
        _counters.pop(name, None)


@dataclasses.dataclass
class FrameStats:
    wall_ms: float = 0.0
    num_splats: int = 0
    num_pairs: int = 0
    overflow: int = 0
    width: int = 0
    height: int = 0

    @property
    def msplats_per_s(self) -> float:
        if self.wall_ms <= 0:
            return 0.0
        return self.num_splats / self.wall_ms / 1e3

    def as_dict(self) -> dict:
        return {**dataclasses.asdict(self),
                "msplats_per_s": round(self.msplats_per_s, 3)}


class Timer:
    """Wall-clock span that waits for the device at exit.

    >>> with Timer() as t:
    ...     out = render(...)
    ...     t.block_on(out["color"])
    >>> t.ms
    """

    def __init__(self):
        self.ms = 0.0
        self._out = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def block_on(self, x):
        self._out = x
        return x

    def __exit__(self, *exc):
        if isinstance(self._out, torch.Tensor) and self._out.is_cuda:
            torch.cuda.synchronize(self._out.device)
        self.ms = (time.perf_counter() - self._t0) * 1e3
        return False


@contextlib.contextmanager
def profile_trace(logdir: str, with_memory: bool = False):
    """Capture a torch.profiler trace of the CPU and, where there is one,
    the CUDA device; writes ``logdir/trace.json`` (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts, profile_memory=with_memory) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def timed_render(render_fn, *args, block_key: Optional[str] = "color",
                 **kwargs):
    """Run a render callable and return (output, FrameStats)."""
    with Timer() as t:
        out = render_fn(*args, **kwargs)
        t.block_on(out[block_key] if block_key else out)
    stats = FrameStats(wall_ms=t.ms)
    if isinstance(out, dict):
        if "num_pairs" in out:
            stats.num_pairs = int(out["num_pairs"])
        if "overflow" in out:
            stats.overflow = int(out["overflow"])
        col = out.get("color")
        if col is not None:
            stats.height, stats.width = col.shape[:2]
    return out, stats
