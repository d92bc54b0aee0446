"""Device ms a frame spends in binning (codecs, pair expansion, the sort
and the record gather), inside the real frame (the span ``gs.bin``)."""

from splatbench import spans


def read(probe):
    return spans.ms_per_call(probe, "orbit", under=("gs.bin",))
