"""Splat datatypes, 3D math, covariance and SH evaluation."""
from .types import Camera, RenderConfig, SplatData, random_splats  # noqa: F401
from . import math3d, sh, covariance  # noqa: F401
