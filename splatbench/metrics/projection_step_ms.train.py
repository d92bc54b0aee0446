"""Device ms a training step spends in the projection, inside the real
step: its forward (the span ``gs.project``) and the self time of
``gs.backward`` (the projection's and ``to_splats``' autograd, the
straight-through codecs and the loss's backward: what the compositor's
and the gather's backward spans leave)."""

from splatbench import spans


def read(probe):
    return spans.ms_per_call(probe, "train", under=("gs.project",),
                             self_of=("gs.backward",))
