"""Scenes of the port's tests made with numpy from a seed, so that the
same splats reach both packages; torch-free, so that the rank processes
of the sharded tests (tests/torch_sharded_worker.py) can import it
without JAX."""

import numpy as np


def scene_arrays(n, sh_degree=0, seed=0, extent=1.0, scale_mul=1.0):
    """random_splats' distributions, drawn with numpy: (means, scales,
    quats, colors, sh) float32 arrays."""
    rng = np.random.default_rng(seed)
    k = {0: 0, 1: 3, 2: 8, 3: 15}[sh_degree]
    means = rng.uniform(-extent, extent, (n, 3))
    scales = rng.uniform(0.005, 0.05, (n, 3)) * extent * scale_mul
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    colors = np.concatenate([rng.uniform(0.0, 1.0, (n, 3)),
                             rng.uniform(0.3, 1.0, (n, 1))], axis=1)
    sh = 0.2 * rng.normal(size=(n, k, 3))
    return tuple(a.astype(np.float32)
                 for a in (means, scales, quats, colors, sh))
