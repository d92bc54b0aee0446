"""The one launch path of the port's CUDA kernels.

A kernel is ``csrc/<name>.cu`` (a C entry point that takes the stream last
and returns the CUDA error code), its name in ``_build.KERNELS``, one
:class:`Kernel` declaration, the one place it is launched and counted, and
one ``*_cuda`` wrapper beside it that checks its inputs
(:func:`check_tensors`, :func:`check_cuda_launch`), allocates its outputs
and calls the declaration; :func:`dispatch` picks that wrapper or the
plain PyTorch version by the tensors' device.  Nothing loads at import.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..utils import metrics

# C argument types of the declarations, in the order of the C signatures
PTR, INT, I64, F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)

DECLARED: dict[str, "Kernel"] = {}
"""Every :class:`Kernel` declared, by library."""


def entry(lib: str, symbol: str, argtypes):
    """C function ``symbol`` of library ``lib`` (``_build.load``), its
    ``argtypes`` set and its result the CUDA error code, an ``int``."""
    fn = getattr(_build.load(lib), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    return fn


class Kernel:
    """Library ``lib``'s C entry point ``symbol``, its C ``argtypes`` (the
    stream last), and the ``utils.metrics`` counter of the ``launches``
    one call makes.  ``kernel(device, *args)`` (the arguments before the
    stream) loads it on first use, calls it under ``torch.cuda.device`` on
    the current stream, raises RuntimeError naming ``lib`` (and ``what``)
    and a nonzero CUDA error code, and adds the launches to the counter
    (recorded while a CUDA graph captures).  The wrapper checks inputs."""

    __slots__ = ("lib", "symbol", "argtypes", "counter", "launches", "_fn")

    def __init__(self, lib: str, symbol: str, argtypes, counter: str,
                 launches: int = 1):
        self.lib, self.symbol, self.argtypes = lib, symbol, tuple(argtypes)
        self.counter, self.launches = counter, launches
        self._fn = None
        DECLARED[lib] = self

    def __call__(self, device, *args, what: str = "") -> None:
        fn = self._fn
        if fn is None:
            fn = self._fn = entry(self.lib, self.symbol, self.argtypes)
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.lib} kernel{what} launch failed: CUDA "
                               f"error {err}")
        metrics.add(self.counter, self.launches)


def check_tensors(device, *specs) -> None:
    """Raise ValueError unless every ``(name, tensor, shape, dtype)`` of
    ``specs``, in order, has that shape and dtype and is contiguous on
    ``device``."""
    for name, t, shape, dtype in specs:
        if t.dtype != dtype or t.shape != shape:
            raise ValueError(f"{name} must be {list(shape)} {dtype}, got "
                             f"{list(t.shape)} {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_cuda_launch(x, name: str) -> None:
    """Raise unless the CUDA kernel wrapper ``name`` can launch on ``x``: a
    tensor on a CUDA device (every tile side >= 1 launches)."""
    if not x.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors")


def dispatch(x, cuda, plain):
    """The function to run on a tensor ``x``: ``cuda`` (a kernel's
    wrapper) on a CUDA device, ``plain`` (its plain PyTorch version) on the
    CPU; ValueError on any other device."""
    if x.is_cuda:
        return cuda
    if x.device.type == "cpu":
        return plain
    raise ValueError(f"no kernel for device {x.device}")
