"""The bin-sort's forward, timed alone: render/binning.py, in the 3D
cells."""

from splatbench import layers


def read(probe):
    return layers.stage_ms(probe, "orbit", "binning", backward=False)
