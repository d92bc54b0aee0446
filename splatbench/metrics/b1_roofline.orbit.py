"""Percent of its roofline reached by B1, the 3D compositor's forward
(csrc/composite_fwd.cu), in the traced orbit frames: the least time the
H100 could take for every traced call's work (splatbench/work.py) over the
kernel's time in all of them.  The kernel is found in the trace by the
names below."""

from splatbench import layers, work

KERNELS = ("composite_fwd_kernel",)


def read(probe):
    return layers.roofline(probe, "orbit", KERNELS, work.b1_work)
