"""The surfel bin-sort's forward and the record gather's backward (to
the projected fields), timed alone: render/surfel.py::bin_sort_surfels, in
the host-bound 2D cells."""

from splatbench import layers


def read(probe):
    return layers.stage_ms(probe, "train", "binning", backward=True)
