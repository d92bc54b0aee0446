"""Core datatypes on torch tensors: splats, cameras, render configuration
(counterpart of the JAX package's ``core/types.py``).

The splat data model is struct-of-arrays:

- ``means [N, 3] f32``    — world-space centers
- ``scales [N, 3] f32``   — per-axis Gaussian extents (already exp()'d)
- ``quats [N, 4] f32``    — rotation quaternions, (x, y, z, w) order
- ``colors [N, 4] f32``   — base RGBA in [0, 1]; RGB has the SH DC band
  baked in, A is the sigmoid'ed opacity
- ``sh [N, K, 3] f32``    — higher-order SH triplets, K in {0, 3, 8, 15}

Every constructor takes an explicit ``device`` and defaults to ``cuda``.
``from_numpy`` carries the JAX package's arrays across unchanged, so both
packages render the same scene.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..constants import (
    DEFAULT_KERNEL_2D_SIZE,
    DEFAULT_MAX_SCREEN_SPACE_SPLAT_SIZE,
    DEFAULT_SORT_BITS,
    DEFAULT_TILE_SIZE,
    MAX_SORT_BITS,
    MIN_SORT_BITS,
    SH_DEGREE_TO_COEFF_COUNT,
)
from . import math3d


def _f32(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


@dataclass
class SplatData:
    """Struct-of-arrays splat container."""

    means: torch.Tensor     # [N, 3]
    scales: torch.Tensor    # [N, 3]
    quats: torch.Tensor     # [N, 4] (x, y, z, w)
    colors: torch.Tensor    # [N, 4] RGBA in [0, 1]
    sh: torch.Tensor        # [N, K, 3]

    @property
    def num_splats(self) -> int:
        return self.means.shape[0]

    @property
    def device(self) -> torch.device:
        return self.means.device

    @property
    def sh_degree(self) -> int:
        k = self.sh.shape[1]
        for deg, count in SH_DEGREE_TO_COEFF_COUNT.items():
            if count == k:
                return deg
        raise ValueError(f"unsupported SH coefficient count {k}")

    def with_sh_degree(self, degree: int) -> "SplatData":
        """Truncate or zero-pad the SH bands to ``degree``."""
        k_new = SH_DEGREE_TO_COEFF_COUNT[degree]
        k_old = self.sh.shape[1]
        if k_new == k_old:
            return self
        if k_new < k_old:
            sh = self.sh[:, :k_new, :]
        else:
            pad = torch.zeros((self.sh.shape[0], k_new - k_old, 3),
                              dtype=self.sh.dtype, device=self.sh.device)
            sh = torch.cat([self.sh, pad], dim=1)
        return dataclasses.replace(self, sh=sh)

    def to(self, device) -> "SplatData":
        """Every field on ``device`` (a field already there is kept)."""
        return SplatData(*(getattr(self, f.name).to(device)
                           for f in dataclasses.fields(SplatData)))

    @staticmethod
    def concatenate(parts: "list[SplatData]") -> "SplatData":
        """One SplatData of ``parts`` in order, every part raised to the
        highest SH degree among them; all parts on one device."""
        degree = max(p.sh_degree for p in parts)
        parts = [p.with_sh_degree(degree) for p in parts]
        return SplatData(*(torch.cat([getattr(p, f.name) for p in parts])
                           for f in dataclasses.fields(SplatData)))

    @staticmethod
    def zeros(n: int, sh_degree: int = 0, device="cuda") -> "SplatData":
        k = SH_DEGREE_TO_COEFF_COUNT[sh_degree]
        return SplatData(
            means=torch.zeros((n, 3), device=device),
            scales=torch.ones((n, 3), device=device),
            quats=torch.tensor([0.0, 0.0, 0.0, 1.0],
                               device=device).repeat(n, 1),
            colors=torch.zeros((n, 4), device=device),
            sh=torch.zeros((n, k, 3), device=device),
        )

    @staticmethod
    def from_numpy(means, scales, quats, colors, sh,
                   device="cuda") -> "SplatData":
        """Float32 tensors on ``device`` from numpy-convertible arrays (the
        JAX package's ``SplatData`` fields, passed through ``np.asarray``)."""
        return SplatData(*(_f32(a, device)
                           for a in (means, scales, quats, colors, sh)))


@dataclass
class Camera:
    """Camera matrices.

    ``view``: world -> camera 4x4 (camera looks down -Z).
    ``proj``: GL-style projection 4x4; pixel focal lengths are
    ``fx = proj[0,0] * W / 2``, ``fy = proj[1,1] * H / 2``.
    ``cam_pos``: camera position in world space (for SH view directions).
    """

    view: torch.Tensor      # [4, 4]
    proj: torch.Tensor      # [4, 4]
    cam_pos: torch.Tensor   # [3]

    @staticmethod
    def look_at(eye, target, up=(0.0, 1.0, 0.0), fov_y_deg: float = 60.0,
                aspect: float = 1.0, near: float = 0.1, far: float = 500.0,
                device="cuda") -> "Camera":
        view = math3d.look_at_view_matrix(eye, target, up, device=device)
        proj = math3d.perspective_projection(fov_y_deg, aspect, near, far,
                                             device=device)
        return Camera(view=view, proj=proj, cam_pos=_f32(eye, device))

    @staticmethod
    def orthographic(eye, target, up=(0.0, 1.0, 0.0),
                     half_height: float = 1.0, aspect: float = 1.0,
                     near: float = 0.1, far: float = 500.0,
                     device="cuda") -> "Camera":
        view = math3d.look_at_view_matrix(eye, target, up, device=device)
        hw = half_height * aspect
        proj = math3d.orthographic_projection(-hw, hw, -half_height,
                                              half_height, near, far,
                                              device=device)
        return Camera(view=view, proj=proj, cam_pos=_f32(eye, device))

    @staticmethod
    def from_numpy(view, proj, cam_pos, device="cuda") -> "Camera":
        return Camera(view=_f32(view, device), proj=_f32(proj, device),
                      cam_pos=_f32(cam_pos, device))


@dataclass(frozen=True)
class RenderConfig:
    """Static rendering configuration, field for field the JAX package's
    (reference Viewer/material options plus pipeline knobs), except:

    - ``backend``: ``'cuda'`` (the hand-written kernels), ``'torch'`` (their
      plain PyTorch versions, CPU tensors only) or ``'auto'`` (``cuda`` for
      tensors on a CUDA device, ``torch`` for CPU tensors).  ``'cuda'`` with
      CPU tensors and ``'torch'`` with CUDA tensors raise.
    - no ``pair_multiplier``/``max_pairs``/``chunk_size``: the fused
      binning path does not read the first two, and the pair chunk is the
      fixed 128 of the compositor kernel.
    """

    width: int = 800
    height: int = 600
    sh_degree: int = 0
    kernel_2d_size: float = DEFAULT_KERNEL_2D_SIZE
    antialiased: bool = False
    splat_scale: float = 1.0
    max_screen_space_splat_size: float = DEFAULT_MAX_SCREEN_SPACE_SPLAT_SIZE
    point_cloud_mode: bool = False
    render_mode_2d: bool = False
    orthographic: bool = False
    focal_adjustment: float = 1.0
    sort_bits: int = DEFAULT_SORT_BITS
    min_alpha: float = 1.0 / 255.0
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    return_depth: bool = False
    backend: str = "auto"
    tile_size: int = DEFAULT_TILE_SIZE
    # Lane slots of the fused expand+sort (1, 2 or 4) and the aux budget
    # (a multiple of N; <= 0 disables the aux path) — see render.binning.
    lanes: int = 2
    aux_multiplier: float = 0.25
    # 'f32' | 'mixed' | 'packed' record codecs (render.binning).
    record_precision: str = "mixed"
    # Serving mode: no slot tie-breaker in the pair sort.
    forward_only: bool = False

    def __post_init__(self):
        if not (MIN_SORT_BITS <= self.sort_bits <= MAX_SORT_BITS):
            raise ValueError(
                f"sort_bits must be in [{MIN_SORT_BITS}, {MAX_SORT_BITS}]")
        if self.sh_degree not in (0, 1, 2, 3):
            raise ValueError("sh_degree must be 0..3")
        if self.backend not in ("auto", "cuda", "torch"):
            raise ValueError("backend must be 'auto', 'cuda' or 'torch'")
        if self.lanes not in (1, 2, 4):
            raise ValueError("lanes must be 1, 2 or 4")
        if self.record_precision not in ("f32", "mixed", "packed"):
            raise ValueError(
                "record_precision must be 'f32', 'mixed' or 'packed'")
        # the JAX package divides by the side (tiles_x); any side >= 1
        # renders, on the CUDA compositors too (above 64 one block walks
        # the tile's 32 x 32 sub-tiles, csrc/warp_cull.cuh)
        if self.tile_size < 1:
            raise ValueError("tile_size must be >= 1")

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_size)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_size)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    def check_backend(self, device: torch.device) -> None:
        """Raise unless ``backend`` suits tensors on ``device``: 'auto'
        suits any device ('cuda' on a CUDA device, 'torch' on the CPU), an
        explicit backend only its own.  The route itself is chosen by the
        tensors' device in each kernel's wrapper."""
        if self.backend == "cuda" and device.type != "cuda":
            raise ValueError(f"backend 'cuda' needs CUDA tensors, got {device}")
        if self.backend == "torch" and device.type != "cpu":
            raise ValueError(f"backend 'torch' runs on CPU tensors, got "
                             f"{device}")


def derive_focal(proj: torch.Tensor, width: int, height: int
                 ) -> torch.Tensor:
    """Pixel focal lengths (fx, fy) from a GL projection matrix (pixels per
    world unit for orthographic projections)."""
    return torch.stack([proj[0, 0] * width * 0.5, proj[1, 1] * height * 0.5])


def random_splats(generator: torch.Generator, n: int, sh_degree: int = 0,
                  extent: float = 1.0, device="cuda") -> SplatData:
    """Synthetic random scene with the JAX package's distributions, drawn
    from ``generator`` (which must live on ``device``)."""
    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=device)
        return u * (hi - lo) + lo

    def normal(shape):
        return torch.randn(shape, generator=generator, device=device)

    means = uniform((n, 3), -extent, extent)
    scales = uniform((n, 3), 0.005, 0.05) * extent
    quats = math3d.normalize(normal((n, 4)))
    rgb = uniform((n, 3), 0.0, 1.0)
    opacity = uniform((n, 1), 0.3, 1.0)
    colors = torch.cat([rgb, opacity], dim=-1)
    k = SH_DEGREE_TO_COEFF_COUNT[sh_degree]
    sh = 0.2 * normal((n, k, 3))
    return SplatData(means=means, scales=scales, quats=quats, colors=colors,
                     sh=sh)
