"""Device ms a training step spends in the backward of binning's record
gather (the scatter-add of each slot's cotangent into its splat), inside
the real step: the program's span ``gs.bin.gather_bwd``."""

from splatbench import spans


def read(probe):
    return spans.ms_per_call(probe, "train", under=("gs.bin.gather_bwd",))
