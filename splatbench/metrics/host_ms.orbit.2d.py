"""Host ms a frame spends inside its span ``gs.render``: the enqueue of the
frame's work, which sets the pace of the host-bound 2D cells."""

from splatbench import spans


def read(probe):
    return spans.host_ms_per_call(probe, "orbit")
