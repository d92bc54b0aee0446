"""Percent of the traced training steps that a replay of the step's CUDA
graph served: the program's counters ``train.graph.replays`` over
``train.graph.replays`` + ``train.graph.eager`` (steps run op by op),
observed while the window is traced.  None on a program without them."""

from splatbench import spans


def read(probe):
    c = spans.counters(probe, "train")
    if c is None:
        return None
    replays = c.get("train.graph.replays", 0)
    steps = replays + c.get("train.graph.eager", 0)
    return 100.0 * replays / steps if steps else None
