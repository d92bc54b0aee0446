"""Scene reveal fade-in: visible-region tracking + fade animation
(counterpart of the JAX package's ``viewer/fade.py``).

Re-implements the reference's progressive-reveal UX
(src/splatmesh/SplatMesh.js:1172-1220 `updateVisibleRegion` /
`updateVisibleRegionFadeDistance`, constants :30-33): as splats stream
in, a "visible region" sphere around the scene center grows; a fade radius
chases it each frame; splats beyond the fade radius ramp to transparent
over 0.75 world units (the fade shader, SplatMaterial.js:347-363 — applied
in projection.project_splats via ``fade_params``).

The region's centre and its largest distance are reduced on the splats'
device; only those four numbers come to the host.  A float32 mean there
sums in another order than numpy's pairwise sum, so the centre may differ
from the JAX package's in its last bits.
"""

from __future__ import annotations

import numpy as np
import torch

from .enums import SceneRevealMode

SCENE_FADEIN_RATE_FAST = 0.012
SCENE_FADEIN_RATE_GRADUAL = 0.003
VISIBLE_REGION_EXPANSION_DELTA = 1.0
FADE_COMPLETE_PERCENT = 0.99


class VisibleRegion:
    """Host-side visible-region + fade state (one per Viewer).

    Call :meth:`update_region` whenever splats are added (or a progressive
    load grows a scene), :meth:`tick` once per rendered frame; pass the
    returned ``fade_params`` to the render pipeline until :attr:`complete`.
    """

    def __init__(self, fade_in_rate_multiplier: float = 1.0):
        self.center = np.zeros(3, np.float32)
        self.max_splat_distance = 0.0
        self.buffer_radius = 0.0
        self.radius = 0.0
        self.fade_start_radius = 0.0
        self.final_build = True
        self.fade_in_rate_multiplier = fade_in_rate_multiplier
        self._has_data = False

    @property
    def complete(self) -> bool:
        if not self._has_data:
            return True
        if self.buffer_radius <= 0.0:
            return False
        return (self.fade_start_radius / self.buffer_radius
                > FADE_COMPLETE_PERCENT)

    def reset(self):
        self.__init__(self.fade_in_rate_multiplier)

    def update_region(self, means, final_build: bool = True,
                      center: np.ndarray | None = None):
        """Grow the visible region to cover ``means`` ([N, 3], model space;
        a tensor on any device, or a numpy array).

        ``final_build=False`` marks a progressive load in flight (the fade
        radius then chases at the gradual rate and the region only expands
        in EXPANSION_DELTA steps, SplatMesh.js:1193-1197).
        """
        means = torch.as_tensor(means, dtype=torch.float32)
        if means.numel() == 0:
            return
        if center is not None:
            self.center = np.asarray(center, np.float32)
        elif not self._has_data:
            self.center = means.mean(dim=0).cpu().numpy()
        self._has_data = True
        self.final_build = final_build
        c = torch.as_tensor(self.center, device=means.device)
        dist = float(torch.linalg.norm(means - c, dim=1).max())
        self.max_splat_distance = max(self.max_splat_distance, dist)
        if (self.max_splat_distance - self.buffer_radius
                > VISIBLE_REGION_EXPANSION_DELTA):
            self.buffer_radius = self.max_splat_distance
            self.radius = max(
                self.buffer_radius - VISIBLE_REGION_EXPANSION_DELTA, 0.0)
        if final_build:
            self.radius = self.buffer_radius = self.max_splat_distance

    def tick(self, reveal_mode: SceneRevealMode = SceneRevealMode.Default):
        """Advance the fade animation one frame; returns ``fade_params``
        (center, fade_start_radius) or None when fading is done/disabled."""
        if not self._has_data or reveal_mode == SceneRevealMode.Instant:
            return None
        fast = SCENE_FADEIN_RATE_FAST * self.fade_in_rate_multiplier
        gradual = SCENE_FADEIN_RATE_GRADUAL * self.fade_in_rate_multiplier
        default_rate = fast if self.final_build else gradual
        rate = (default_rate if reveal_mode == SceneRevealMode.Default
                else gradual)
        self.fade_start_radius += (self.radius - self.fade_start_radius) * rate
        if self.complete:
            return None
        return (self.center.copy(), float(self.fade_start_radius))
