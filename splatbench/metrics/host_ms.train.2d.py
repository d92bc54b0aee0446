"""Host ms a training step spends inside its span ``gs.train.step`` (main
thread): the enqueue of the step's work, which sets the pace of the
host-bound 2D cells."""

from splatbench import spans


def read(probe):
    return spans.host_ms_per_call(probe, "train")
