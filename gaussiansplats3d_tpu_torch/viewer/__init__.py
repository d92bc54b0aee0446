"""The viewer layer: so far only its enums (the viewer slice ports the
rest)."""

from .enums import (  # noqa: F401
    LogLevel,
    RenderMode,
    SceneRevealMode,
    SplatRenderMode,
)
