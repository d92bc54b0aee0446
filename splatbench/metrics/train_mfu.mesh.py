"""Percent of the H100's float32 peak (67 TFLOP/s outside the tensor cores)
that rank 0 reached in a mesh training step: the counted operations of its
part of every traced step (``work.py``: B1 and B2 on its slab's records,
the projection of its shard's splats in view, forward and backward) over
the traced window, read where the program names its exchange
(``gs.exchange``)."""

from splatbench import spans, work


def read(probe):
    sp = spans.of(probe)
    run = probe.run
    if sp is None or not sp.count("gs.exchange") or \
            not hasattr(run, "slab_ops") or not run.traced_views:
        return None
    ops = [run.slab_ops(v) for v in run.traced_views]
    if any(o is None for o in ops) or probe.trace.window_s <= 0.0:
        return None
    return 100.0 * sum(ops) / (probe.trace.window_s * work.PEAK_F32_FLOPS)
