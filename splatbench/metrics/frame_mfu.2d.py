"""Percent of the H100's float32 peak (67 TFLOP/s outside the tensor cores)
that a whole 2D orbit frame reached: the surfel compositor's counted
operations (B3) and the surfel projection's forward for the surfels in
view, over the traced window's mean frame time."""

from splatbench import layers, work


def read(probe):
    return layers.mfu(probe, "orbit", (work.b3_work,), backward=False)
