"""Aux pairs dropped a binning call, over the traced steps: the program's
counter ``bin.dropped`` (pairs past the aux capacity) over ``bin.calls``.
A dropped pair is a pair the image lacks."""

from splatbench import spans


def read(probe):
    return spans.dropped_pairs(probe, "train")
