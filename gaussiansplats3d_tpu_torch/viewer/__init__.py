"""Viewer-parity API: multi-scene management + offscreen rendering
(counterpart of the JAX package's ``viewer/``).

The reference's L7 layer (src/Viewer.js, src/DropInViewer.js) re-imagined
headless: no DOM/WebGL/controls, just scene lifecycle + render calls that
produce image tensors on the viewer's device.
"""

from .enums import (  # noqa: F401
    LogLevel,
    RenderMode,
    SceneRevealMode,
    SplatRenderMode,
)
from .info_panel import InfoPanel  # noqa: F401
from .helpers import (  # noqa: F401
    apply_overlay,
    composite_with_depth,
    focus_marker_overlay,
    mesh_cursor_overlay,
    project_to_screen,
)
from .orbit import OrbitCamera  # noqa: F401
from .raycaster import Hit, Ray, Raycaster  # noqa: F401
from .scene import SplatScene  # noqa: F401
from .splattree import SplatTree  # noqa: F401
from .viewer import Viewer  # noqa: F401
