"""Training and the multi-device layer: parameters, the train step,
densify/prune; the (splat, tile) device mesh over torch.distributed ranks,
the sharded render, the bootstrap and checkpoints."""

from .distributed import (  # noqa: F401
    initialize_distributed,
    load_checkpoint,
    save_checkpoint,
)
from .heuristics import (  # noqa: F401
    DensifyConfig,
    DensifyState,
    densify_and_prune,
)
from .mesh import make_mesh  # noqa: F401
from .sharded import (  # noqa: F401
    default_exchange_capacity,
    deinterleave_tile_order,
    device_put_sharded_splats,
    interleave_tile_order,
    pad_splats_for_mesh,
    sharded_render,
    sharded_render_tiles,
)
from .train import TrainState, make_train_step  # noqa: F401
