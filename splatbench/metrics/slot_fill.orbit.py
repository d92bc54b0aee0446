"""Percent of binning's pair slots (lanes, aux and padding) that hold a
kept pair, over the traced frames: the program's counters ``bin.pairs_kept``
and ``bin.slots``.  Every empty slot still takes part in the sort and the
gather."""

from splatbench import spans


def read(probe):
    return spans.slot_fill(probe, "orbit")
