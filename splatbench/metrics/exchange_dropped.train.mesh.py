"""Records the routed exchange dropped a call (past its capacity), over
rank 0's traced steps: the program's counters ``exchange.dropped`` over
``exchange.calls``.  A dropped record is a splat a slab lacks."""

from splatbench import spans


def read(probe):
    c = spans.counters(probe, "train")
    if c is None or not c.get("exchange.calls"):
        return None
    return c.get("exchange.dropped", 0) / c["exchange.calls"]
