"""Percent of the H100's float32 peak (67 TFLOP/s outside the tensor cores)
that a whole training step reached: the compositors' counted operations
(B1 + B2) and the projection's forward and backward for the splats in
view, over the traced window's mean step time."""

from splatbench import layers, work


def read(probe):
    return layers.mfu(probe, "train", (work.b1_work, work.b2_work),
                      backward=True)
