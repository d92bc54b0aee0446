"""Shared pieces of the port's tests (tests/test_torch_*.py): scenes made
with numpy from a seed and fed to both packages, error-mass measures, the
fixture that decides at test time whether a CUDA card is present, and the
one that runs the JAX package's Pallas kernels in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import gaussiansplats3d_tpu as gs
import gaussiansplats3d_tpu_torch as gt
from gaussiansplats3d_tpu.render import pallas_rasterize as pr

# Six xdist workers share the machine.
torch.set_num_threads(2)


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


def both_scenes(arrays, device="cpu"):
    """The same splats as a JAX SplatData and a port SplatData."""
    return (gs.SplatData(*(jnp.asarray(a) for a in arrays)),
            gt.SplatData.from_numpy(*arrays, device=device))


def both_cameras(cam_j, device="cpu"):
    """A JAX camera and the port's copy of its matrices."""
    return cam_j, gt.Camera.from_numpy(np.asarray(cam_j.view),
                                       np.asarray(cam_j.proj),
                                       np.asarray(cam_j.cam_pos),
                                       device=device)


def error_mass(a, b, bar=1e-2):
    """(p99.9 of |a - b|, share of elements with |a - b| > bar)."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(np.quantile(d, 0.999)), float(np.mean(d > bar))


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip: decided when the test runs, never at
    import time, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run pallas_call in interpret mode, as tests/test_pallas.py does."""
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pr.pl, "pallas_call", patched)
