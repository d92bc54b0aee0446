"""gaussiansplats3d_tpu_torch — the PyTorch/CUDA port of gaussiansplats3d_tpu.

The JAX package beside it is the reference; this package imports neither
JAX nor anything of it.  It ports the 3DGS render and its gradients:
projection, tile binning and depth sort, the tile compositor forward and
backward (hand-written CUDA kernels for Hopper, with plain PyTorch versions
for CPU tensors) and image assembly; training; and the 2DGS
surfel mode (``RenderConfig(render_mode_2d=True)``) with its own compositor
kernels; scene-file IO (``load``/``save``: .ply, .splat, .ksplat, .spz,
from paths and URLs, progressive loading, ``optimize_splat_data``) and
``bake_transform``; the Viewer (``Viewer``: multi-scene composition,
render gating, the reveal fade, stereo, picking); the multi-device layer
(``parallel``: a (splat, tile) mesh of torch.distributed ranks, the
sharded render and training step, checkpoints); and the tools
(``tools/``: training, rendering and converting scenes, the compositor
ablation bench with its kernel, the stage profile, the card's parity
gate, the acceptance configs, the scaling harness).  Constructors put
tensors on ``cuda`` unless given ``device="cpu"``.
"""

from . import io  # noqa: F401
from . import utils  # noqa: F401
from . import viewer  # noqa: F401
from .constants import MAX_SCENES  # noqa: F401
from .core.bake import bake_transform  # noqa: F401
from .core.types import Camera, RenderConfig, SplatData, random_splats  # noqa: F401
from .io import load, save  # noqa: F401
from .render.oracle import reference_render  # noqa: F401
from .render.pipeline import render, render_batch, stack_cameras  # noqa: F401
from .viewer import OrbitCamera, Viewer  # noqa: F401

__version__ = "0.1.0"
