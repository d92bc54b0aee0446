"""Kernel launch calls (``cudaLaunchKernel*``, ``cuLaunchKernel*``) a
training step makes inside its span ``gs.train.step``, on any thread (the
backward launches from autograd's device thread)."""

from splatbench import spans


def read(probe):
    return spans.launches_per_call(probe, "train")
