"""Device ms a frame spends in the projection, inside the real frame (the
span ``gs.project``)."""

from splatbench import spans


def read(probe):
    return spans.ms_per_call(probe, "orbit", under=("gs.project",))
