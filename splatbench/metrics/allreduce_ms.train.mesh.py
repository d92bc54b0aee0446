"""Device ms a mesh training step spends in the tile group's all-reduce of
the replicated splats' gradients, inside the real step on rank 0: the
program's span ``gs.allreduce``, its NCCL kernel included."""

from splatbench import spans


def read(probe):
    return spans.ms_per_call(probe, "train", under=("gs.allreduce",))
