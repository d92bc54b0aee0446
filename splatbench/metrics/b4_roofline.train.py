"""Percent of its roofline reached by B4, the surfel compositor's backward
(csrc/surfel_bwd.cu), in the traced training steps: the least time the H100
could take for every traced call's work (splatbench/work.py) over the
kernel's time in all of them.  The kernel is found in the trace by the
names below."""

from splatbench import layers, work

KERNELS = ("surfel_bwd_kernel",)


def read(probe):
    return layers.roofline(probe, "train", KERNELS, work.b4_work)
