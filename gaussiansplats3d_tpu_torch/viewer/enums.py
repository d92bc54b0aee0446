"""Viewer enums — parity with the reference's enum modules
(src/RenderMode.js, SceneRevealMode.js, SplatRenderMode.js, LogLevel.js);
the port's copy of the JAX package's ``viewer/enums.py``."""

import enum


class RenderMode(enum.IntEnum):
    """When the viewer re-renders (RenderMode.js)."""
    Always = 0
    OnChange = 1
    Never = 2


class SceneRevealMode(enum.IntEnum):
    """Scene fade-in behavior (SceneRevealMode.js)."""
    Default = 0
    Gradual = 1
    Instant = 2


class SplatRenderMode(enum.IntEnum):
    """3D EWA splats vs 2D surfels (SplatRenderMode.js)."""
    ThreeD = 0
    TwoD = 1


class LogLevel(enum.IntEnum):
    """Logging verbosity (LogLevel.js)."""
    NONE = 0
    ERROR = 1
    WARNING = 2
    INFO = 3
    DEBUG = 4
