"""The surfel projection's forward under no_grad, timed alone on the
cell's cameras: render/surfel.py::project_surfels, in the host-bound 2D
cells."""

from splatbench import layers


def read(probe):
    return layers.stage_ms(probe, "orbit", "projection", backward=False)
