"""Percent of the routed exchange's slots that carry a record, over rank
0's traced steps: the program's counters ``exchange.kept`` over
``exchange.slots``.  Every empty slot still crosses the wire both ways and
is binned by every rank of the splat group."""

from splatbench import spans


def read(probe):
    c = spans.counters(probe, "train")
    if c is None or not c.get("exchange.slots"):
        return None
    return 100.0 * c.get("exchange.kept", 0) / c["exchange.slots"]
