"""Percent of the traced orbit window in which no operation ran on the
device, in the host-bound 2D cells."""

from splatbench import layers


def read(probe):
    return layers.device_idle(probe, "orbit")
