"""The surfel projection's forward and backward (to the parameters),
timed alone on the cell's views: render/surfel.py::project_surfels, in
the host-bound 2D cells."""

from splatbench import layers


def read(probe):
    return layers.stage_ms(probe, "train", "projection", backward=True)
