"""Kernel launch calls (``cudaLaunchKernel*``, ``cuLaunchKernel*``) a frame
makes inside its span ``gs.render``."""

from splatbench import spans


def read(probe):
    return spans.launches_per_call(probe, "orbit")
