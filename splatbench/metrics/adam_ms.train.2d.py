"""One adam(lr) step over the cell's parameters, timed alone:
parallel/train.py's optimizer, in the host-bound 2D cells."""

from splatbench import layers


def read(probe):
    return layers.adam_ms(probe, "train")
