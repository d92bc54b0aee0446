"""Headless orbit-camera controller (counterpart of the JAX package's
``viewer/orbit.py``).

The math of the reference's forked three.js OrbitControls
(src/OrbitControls.js) without DOM events: spherical orbit
around a target with rotate / pan / zoom(dolly) operations and optional
polar clamps.  Drives `Camera` objects for offscreen rendering.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from ..core.types import Camera


class OrbitCamera:
    def __init__(self, position: Sequence[float] = (0.0, 0.0, 5.0),
                 target: Sequence[float] = (0.0, 0.0, 0.0),
                 up: Sequence[float] = (0.0, 1.0, 0.0),
                 fov_y_deg: float = 60.0, aspect: float = 1.0,
                 near: float = 0.1, far: float = 500.0,
                 min_distance: float = 1e-3, max_distance: float = 1e6,
                 min_polar: float = 1e-3, max_polar: float = math.pi - 1e-3):
        self.target = np.asarray(target, np.float64)
        self.up = np.asarray(up, np.float64)
        self.fov_y_deg = fov_y_deg
        self.aspect = aspect
        self.near, self.far = near, far
        self.min_distance, self.max_distance = min_distance, max_distance
        self.min_polar, self.max_polar = min_polar, max_polar

        offset = np.asarray(position, np.float64) - self.target
        self.radius = float(np.linalg.norm(offset))
        # spherical coords in the up-frame
        self._basis = self._up_basis(self.up)
        local = self._basis.T @ offset
        self.theta = math.atan2(local[0], local[2])  # azimuth
        self.phi = math.acos(np.clip(local[1] / max(self.radius, 1e-12),
                                     -1.0, 1.0))

    @staticmethod
    def _up_basis(up):
        y = up / np.linalg.norm(up)
        x = np.cross(y, [0.0, 0.0, 1.0])
        if np.linalg.norm(x) < 1e-6:
            x = np.cross(y, [1.0, 0.0, 0.0])
        x /= np.linalg.norm(x)
        z = np.cross(x, y)
        return np.stack([x, y, z], axis=1)

    @property
    def position(self) -> np.ndarray:
        local = np.array([
            self.radius * math.sin(self.phi) * math.sin(self.theta),
            self.radius * math.cos(self.phi),
            self.radius * math.sin(self.phi) * math.cos(self.theta)])
        return self.target + self._basis @ local

    @position.setter
    def position(self, position: Sequence[float]) -> None:
        """Move the eye, keeping the current target (like repositioning the
        camera object under the reference's OrbitControls)."""
        offset = np.asarray(position, np.float64) - self.target
        self.radius = float(np.linalg.norm(offset))
        local = self._basis.T @ offset
        self.theta = math.atan2(local[0], local[2])
        self.phi = math.acos(np.clip(local[1] / max(self.radius, 1e-12),
                                     -1.0, 1.0))

    def rotate(self, d_azimuth: float, d_polar: float) -> "OrbitCamera":
        self.theta += d_azimuth
        self.phi = float(np.clip(self.phi + d_polar, self.min_polar,
                                 self.max_polar))
        return self

    def zoom(self, factor: float) -> "OrbitCamera":
        """factor > 1 moves closer (dolly in)."""
        self.radius = float(np.clip(self.radius / factor, self.min_distance,
                                    self.max_distance))
        return self

    def pan(self, dx: float, dy: float) -> "OrbitCamera":
        """Pan in the camera plane by world-space units."""
        eye = self.position
        fwd = self.target - eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, self.up)
        right /= np.linalg.norm(right)
        cam_up = np.cross(right, fwd)
        self.target = self.target + right * dx + cam_up * dy
        return self

    def set_target(self, target: Sequence[float]) -> "OrbitCamera":
        eye = self.position
        self.target = np.asarray(target, np.float64)
        offset = eye - self.target
        self.radius = float(np.linalg.norm(offset))
        local = self._basis.T @ offset
        self.theta = math.atan2(local[0], local[2])
        self.phi = math.acos(np.clip(local[1] / max(self.radius, 1e-12),
                                     -1.0, 1.0))
        return self

    def camera(self, device="cuda") -> Camera:
        """The current view as a perspective Camera on ``device``."""
        return Camera.look_at(tuple(self.position), tuple(self.target),
                              tuple(self.up), fov_y_deg=self.fov_y_deg,
                              aspect=self.aspect, near=self.near,
                              far=self.far, device=device)
