"""The projection's forward and backward (to the parameters), timed alone
on the cell's views: render/projection.py, in the 3D cells."""

from splatbench import layers


def read(probe):
    return layers.stage_ms(probe, "train", "projection", backward=True)
