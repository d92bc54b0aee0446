"""Percent of the traced training window in which no operation ran on the
device."""

from splatbench import layers


def read(probe):
    return layers.device_idle(probe, "train")
