"""The two crossings between the IO modules' numpy arrays and the port's
``SplatData``."""

from __future__ import annotations

import numpy as np

from ..core.types import SplatData


def to_splatdata(means, scales, quats, colors, sh, device) -> SplatData:
    """Float32 tensors on ``device`` from decoded numpy arrays."""
    return SplatData.from_numpy(means, scales, quats, colors, sh,
                                device=device)


def host_arrays(splats: SplatData):
    """(means, scales, quats, colors, sh) as C-contiguous float32 numpy
    arrays on the host, from tensors on any device and of any strides."""
    return tuple(np.ascontiguousarray(
        getattr(splats, f).detach().cpu().numpy(), np.float32)
        for f in ("means", "scales", "quats", "colors", "sh"))
