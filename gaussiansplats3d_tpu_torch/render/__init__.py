"""The render path: projection, binning, compositing, assembly."""
from .projection import ProjectedSplats, project_splats, quantize_depth  # noqa: F401
from .oracle import reference_render  # noqa: F401
