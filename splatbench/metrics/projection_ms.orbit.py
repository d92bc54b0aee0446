"""The projection's forward under no_grad, timed alone on the cell's
cameras: render/projection.py, in
the 3D cells."""

from splatbench import layers


def read(probe):
    return layers.stage_ms(probe, "orbit", "projection", backward=False)
