"""The surfel bin-sort's forward, timed alone:
render/surfel.py::bin_sort_surfels, in the host-bound 2D cells."""

from splatbench import layers


def read(probe):
    return layers.stage_ms(probe, "orbit", "binning", backward=False)
