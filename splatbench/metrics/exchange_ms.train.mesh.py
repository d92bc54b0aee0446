"""Device ms a mesh training step spends in the routed exchange, inside the
real step on rank 0: the program's spans ``gs.exchange`` (the forward's
compaction and its all-gather over the splat group) and ``gs.exchange.bwd``
(the backward's reduce-scatters and the scatter-add to the source rows),
the NCCL kernels they launch included."""

from splatbench import spans


def read(probe):
    return spans.ms_per_call(probe, "train",
                             under=("gs.exchange", "gs.exchange.bwd"))
