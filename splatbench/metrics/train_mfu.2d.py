"""Percent of the H100's float32 peak (67 TFLOP/s outside the tensor cores)
that a whole 2D training step reached: the surfel compositors' counted
operations (B3 + B4) and the surfel projection's forward and backward for
the surfels in view, over the traced window's mean step time."""

from splatbench import layers, work


def read(probe):
    return layers.mfu(probe, "train", (work.b3_work, work.b4_work),
                      backward=True)
