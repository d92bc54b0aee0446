"""Splat-data optimization: the SplatPartitioner / SplatBufferGenerator
pipeline (src/loaders/SplatPartitioner.js:46-99,
SplatBufferGenerator.js:17-31), vectorized; counterpart of the JAX
package's ``io/optimize.py``.

``optimize_splat_data`` reorders splats by (0.5-unit-clamped) squared
distance from the scene center — cache/streaming locality so near splats
load and render first — and partitions them into fixed-size sections for
multi-section .ksplat output and progressive loading.  The order is
numpy's stable argsort of float32 distances on the host, as in the JAX
package, so both give the same order bit for bit; only the final index
goes to the splats' device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.types import SplatData

CLAMP_DISTANCE = 0.5


def take_splats(splats: SplatData, idx) -> SplatData:
    """The splats at ``idx`` (an index tensor on their device, or a
    slice), every field indexed alike."""
    return SplatData(splats.means[idx], splats.scales[idx],
                     splats.quats[idx], splats.colors[idx], splats.sh[idx])


def optimize_splat_data(splats: SplatData,
                        scene_center: Sequence[float] = (0.0, 0.0, 0.0),
                        section_size: Optional[int] = None,
                        alpha_removal_threshold: int = 1,
                        ) -> List[SplatData]:
    """Filter + reorder + partition. Returns the list of section SplatDatas.

    - alpha_removal_threshold: u8 opacity cutoff (>= kept), like the
      generator's minimumAlpha.
    - section_size: splats per section (None = single section).
    """
    means = splats.means.detach().cpu().numpy()
    opacity_u8 = splats.colors[:, 3].detach().cpu().numpy() * 255.0
    keep = np.nonzero(opacity_u8 >= alpha_removal_threshold)[0]

    center = np.asarray(scene_center, np.float32)
    rel = means[keep] - center
    clamped = np.floor(rel / CLAMP_DISTANCE) * CLAMP_DISTANCE
    dist_sq = np.sum(clamped * clamped, axis=1)
    order = keep[np.argsort(dist_sq, kind="stable")]

    reordered = take_splats(splats,
                            torch.from_numpy(order).to(splats.device))
    n = len(order)
    if not section_size or section_size >= n:
        return [reordered]
    return [take_splats(reordered, slice(start, start + section_size))
            for start in range(0, n, section_size)]
