"""The arithmetic of the per-layer metrics, which the small readers in
``metrics/`` call with their own parameters (their path kind, their
kernels' names, their work count).

A reader gets a :class:`Probe` after a traced run's window: the run's
state still alive, its timeline (``trace.Trace``) and the views its
traced steps or frames took.  A reader that finds nothing to read (a
kernel that did not run, a path of another kind) returns None, and the
metric is left out of the line.

Stages are timed alone on the cell's own views with CUDA events, after a
warm call, as ``tools/profile_stages.py`` times them; rooflines divide
the least time the H100 could take for the work that every traced call
needed (``work.py``) by the kernels' time in all of them.
"""

from __future__ import annotations

import torch

from splatbench import program, work

STAGE_VIEWS = 3          # views a stage is timed on
STAGE_REPS = 3           # timed calls of a stage per view


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events, after a
    warm call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


class Probe:
    """What the readers read: the run (``kind``, ``gt``, ``cfg``,
    ``cams``, ``splats()``, ``traced_views``) and its trace."""

    def __init__(self, run, trace):
        self.run = run
        self.trace = trace
        self.kind = run.kind
        # a number of the card is never read from a CPU run
        self.on_card = run.dev.type == "cuda"
        self._records = (None, None)     # the last view's, alone
        self._work = {}

    def stage_views(self):
        seen = []
        for v in self.run.traced_views:
            if v not in seen:
                seen.append(v)
        return seen[:STAGE_VIEWS]

    def records(self, view: int):
        """The program's records, tile windows and tile exits for a view,
        as its compositors see them (current parameters), and the splats
        in view.  Only the last view's are kept: a frame's records are
        most of a gigabyte at 5M splats."""
        if self._records[0] != view:
            self._records = (None, None)
            r = self.run
            with torch.no_grad():
                proj, mask = program.project(r.gt, r.splats(), r.cams[view],
                                             r.cfg)
                recs, starts, counts, _, _ = program.bin_records(r.gt, proj,
                                                                 r.cfg)
                exit_k = program.tile_exits(r.gt, recs, starts, counts, r.cfg)
            self._records = (view, (recs, starts, counts, exit_k,
                                    int(mask.sum())))
        return self._records[1]

    def work_of(self, view: int, fn):
        """``fn``'s (operations, bytes) for a view's records."""
        if (view, fn) not in self._work:
            recs, starts, counts, exit_k, _ = self.records(view)
            cfg = self.run.cfg
            geom = (cfg.tile_size, cfg.tiles_x, cfg.num_tiles)
            self._work[(view, fn)] = fn(recs, starts, counts, exit_k, geom,
                                        cfg.min_alpha)
        return self._work[(view, fn)]


def stage_ms(probe: Probe, kind: str, stage: str, backward: bool):
    """Mean ms of the projection or the binning alone over the run's
    views: forward only, or forward and backward (the projection's to the
    parameters; the binning's, the record gather's, to the projected
    fields)."""
    if probe.kind != kind or not probe.on_card:
        return None
    r = probe.run
    ms = []
    for v in probe.stage_views():
        cam = r.cams[v]
        if stage == "projection":
            def fn():
                with torch.set_grad_enabled(backward):
                    proj, _ = program.project(r.gt, r.splats(), cam, r.cfg)
                    if backward:
                        fields = program.projected_fields(proj, r.cfg)
                        torch.autograd.backward(
                            fields, [torch.ones_like(f) for f in fields])
        else:
            with torch.no_grad():
                proj, _ = program.project(r.gt, r.splats(), cam, r.cfg)
            pq = program.with_leaves(proj, r.cfg) if backward else proj

            def fn():
                with torch.set_grad_enabled(backward):
                    recs = program.bin_records(r.gt, pq, r.cfg)[0]
                    if backward:
                        torch.autograd.backward(recs, torch.ones_like(recs))
        ms.append(cuda_ms(fn, STAGE_REPS))
    return sum(ms) / len(ms) if ms else None


def roofline(probe: Probe, kind: str, names, work_fn):
    """Percent of its roofline a kernel reached in the traced window: the
    least time for every traced call's work at the H100's peaks over the
    kernel's time in all those calls.  One launch per call."""
    if probe.kind != kind:
        return None
    durs = probe.trace.kernel_durations(names)
    calls = probe.run.traced_views
    if not durs or len(durs) != len(calls):
        return None
    bound = 0.0
    for v in calls:
        ops, nbytes = probe.work_of(v, work_fn)
        bound += work.bound_of(ops, nbytes)[0]
    return 100.0 * bound / (sum(durs) * 1e3)


def mfu(probe: Probe, kind: str, work_fns, backward: bool):
    """Percent of the H100's float32 peak that the whole step (or frame)
    reached: the counted operations of the compositors and the projection
    of the splats in view, over the traced window's mean step time."""
    if (probe.kind != kind or not probe.on_card
            or not probe.run.traced_views):
        return None
    calls = probe.run.traced_views
    cfg = probe.run.cfg
    ops = 0.0
    for v in calls:
        for fn in work_fns:
            ops += probe.work_of(v, fn)[0]
        in_view = probe.records(v)[4]
        ops += work.projection_ops(in_view, cfg.sh_degree,
                                   cfg.render_mode_2d, backward)
    return 100.0 * ops / (probe.trace.window_s * work.PEAK_F32_FLOPS)


def adam_ms(probe: Probe, kind: str):
    """ms of one ``adam(lr)`` step over copies of the run's parameters,
    with gradients set."""
    if probe.kind != kind or not probe.on_card:
        return None
    r = probe.run
    tp = program.train_parts(r.gt)
    params = [p.detach().clone().requires_grad_(True)
              for p in r.state.params.parameters()]
    for p in params:
        p.grad = torch.randn_like(p) * 1e-6
    opt = tp.adam(float(r.mix["lr"]))(params)
    ms = cuda_ms(opt.step, 5)
    del opt, params
    return ms


def device_idle(probe: Probe, kind: str):
    """Percent of the traced window in which no operation ran on the
    device."""
    if (probe.kind != kind or not probe.trace.device
            or probe.trace.window_s <= 0.0):
        return None
    return 100.0 * (1.0 - probe.trace.busy_s / probe.trace.window_s)
