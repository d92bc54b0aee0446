"""The bin-sort's forward and the record gather's backward (to the
projected fields), timed alone: render/binning.py, in the 3D
cells."""

from splatbench import layers


def read(probe):
    return layers.stage_ms(probe, "train", "binning", backward=True)
