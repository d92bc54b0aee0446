"""Percent of its roofline reached by B3, the surfel compositor's forward
(csrc/surfel_fwd.cu), in the traced orbit frames: the least time the H100
could take for every traced call's work (splatbench/work.py) over the
kernel's time in all of them.  The kernel is found in the trace by the
names below."""

from splatbench import layers, work

KERNELS = ("surfel_fwd_kernel",)


def read(probe):
    return layers.roofline(probe, "orbit", KERNELS, work.b3_work)
