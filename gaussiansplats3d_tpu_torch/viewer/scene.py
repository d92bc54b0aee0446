"""Per-scene descriptor — parity with the reference's SplatScene
(src/splatmesh/SplatScene.js:6-37): splat data + TRS transform +
opacity/visibility; counterpart of the JAX package's ``viewer/scene.py``."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core import math3d
from ..core.types import SplatData


class SplatScene:
    """A splat scene instance inside a Viewer.

    Mutating the transform/opacity/visibility takes effect on the next
    render (the reference's dynamicScene mode; SplatMaterial.js:140-147).
    The transform lives on the host; the splats on their device.
    """

    _version_counter = 0

    def __init__(self, splats: SplatData,
                 position: Optional[Sequence[float]] = None,
                 rotation: Optional[Sequence[float]] = None,
                 scale: Optional[Sequence[float]] = None,
                 opacity: float = 1.0,
                 visible: bool = True,
                 name: Optional[str] = None):
        self.splats = splats
        self._position = np.asarray(position if position is not None
                                    else (0.0, 0.0, 0.0), np.float32)
        self._rotation = np.asarray(rotation if rotation is not None
                                    else (0.0, 0.0, 0.0, 1.0), np.float32)
        self._scale = np.asarray(scale if scale is not None
                                 else (1.0, 1.0, 1.0), np.float32)
        self.opacity = float(opacity)
        self.visible = bool(visible)
        self.name = name

    @property
    def splats(self) -> SplatData:
        return self._splats

    @splats.setter
    def splats(self, value: SplatData):
        # Monotonic content version: render caches key on this rather than
        # id(splats) (ids get recycled, and progressive loads re-assign).
        SplatScene._version_counter += 1
        self._splats_version = SplatScene._version_counter
        self._splats = value

    @property
    def splats_version(self) -> int:
        return self._splats_version

    # --- transform accessors (three.js Object3D-ish surface) ---
    @property
    def position(self) -> np.ndarray:
        return self._position

    @position.setter
    def position(self, v):
        self._position = np.asarray(v, np.float32)

    @property
    def quaternion(self) -> np.ndarray:
        """Rotation quaternion (x, y, z, w)."""
        return self._rotation

    @quaternion.setter
    def quaternion(self, v):
        self._rotation = np.asarray(v, np.float32)

    @property
    def scale(self) -> np.ndarray:
        return self._scale

    @scale.setter
    def scale(self, v):
        self._scale = np.asarray(v, np.float32)

    @property
    def transform(self) -> torch.Tensor:
        """Composed 4x4 model matrix (SplatScene.js `transform`): float32,
        on the CPU."""
        return math3d.compose_transform(self._position, self._rotation,
                                        self._scale, device="cpu")

    @property
    def num_splats(self) -> int:
        return self.splats.num_splats
