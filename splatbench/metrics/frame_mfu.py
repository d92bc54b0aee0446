"""Percent of the H100's float32 peak (67 TFLOP/s outside the tensor cores)
that a whole orbit frame reached: the forward compositor's counted
operations (B1) and the projection's forward for the splats
in view, over the traced window's mean frame time."""

from splatbench import layers, work


def read(probe):
    return layers.mfu(probe, "orbit", (work.b1_work,), backward=False)
