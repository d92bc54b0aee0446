"""Percent of binning's pair slots (lanes, aux and padding) that hold a
kept pair, over the traced steps: the program's counters ``bin.pairs_kept``
and ``bin.slots``.  Every empty slot still takes part in the sort, the
gather and the gather's backward."""

from splatbench import spans


def read(probe):
    return spans.slot_fill(probe, "train")
