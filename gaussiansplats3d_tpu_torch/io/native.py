"""ctypes bindings for the port's native scene decoders (``csrc/ingest.cpp``;
counterpart of the JAX package's ``io/native.py``).

The library holds multithreaded C++ decoders for ``.splat`` rows, INRIA v1
binary ``.ply`` vertex blocks and ``.ksplat`` sections.  It is built with
``g++`` at first use into ``_build/`` (:func:`.._build.build_host`), never
at import.  Each decoder returns numpy float32 arrays, or None when the
library is unavailable: ``GS_NATIVE=0`` in the environment (read at every
call, the same variable the JAX package reads), or a failed build or load.
The IO modules then take their numpy rows, whose results agree with the
native ones to 1e-6 (``exp``, ``sqrt`` and the divisions round differently
in the last place; colors and opacities are equal).

Nothing falls back silently: :func:`status` says why the library is
absent (the compiler's output, say), and :func:`decode_counts` counts the
decodes of each format by the path they took (``native`` or ``numpy``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from .. import _build

FORMATS = ("splat", "ply", "ksplat")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL | None] = {}      # by build directory
_reasons: dict[str, str] = {}
_counts = {f: {"native": 0, "numpy": 0} for f in FORMATS}


def _enabled() -> bool:
    return os.environ.get("GS_NATIVE", "1") != "0"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.gs_parse_splat.restype = ctypes.c_int
    lib.gs_parse_splat.argtypes = [i8p, ctypes.c_int64, f32p, f32p, f32p,
                                   f32p]
    lib.gs_parse_ply_inria_v1.restype = ctypes.c_int
    lib.gs_parse_ply_inria_v1.argtypes = [
        i8p, ctypes.c_int64, ctypes.c_int64, i32p, i32p, ctypes.c_int32,
        ctypes.c_int32, f32p, f32p, f32p, f32p, f32p]
    lib.gs_parse_ksplat_section.restype = ctypes.c_int
    lib.gs_parse_ksplat_section.argtypes = [
        i8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, i32p, f32p,
        ctypes.c_float, ctypes.c_int32, ctypes.c_float, ctypes.c_float,
        f32p, f32p, f32p, f32p, f32p]
    return lib


def get_lib(build_dir=None):
    """The loaded library (built into ``build_dir``, default ``_build/``,
    on first use), or None when ``GS_NATIVE=0`` or the build or load
    failed (then :func:`status` says why)."""
    if not _enabled():
        return None
    key = str(build_dir or _build.BUILD_DIR)
    with _lock:
        if key not in _libs:
            try:
                path = _build.build_host("ingest", build_dir)
                _libs[key] = _bind(ctypes.CDLL(str(path)))
                _reasons[key] = f"loaded {path}"
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _libs[key] = None
                _reasons[key] = f"unavailable: {e}"
        return _libs[key]


def status(build_dir=None) -> str:
    """Why the decoders take the path they take: ``GS_NATIVE=0``, the
    loaded library's path, the build's or the load's error, or that no
    decode has asked for the library yet."""
    if not _enabled():
        return "disabled by GS_NATIVE=0"
    return _reasons.get(str(build_dir or _build.BUILD_DIR), "not built yet")


def record_decode(fmt: str, path: str) -> None:
    """Count one decode of ``fmt`` (one of :data:`FORMATS`; a ``.ksplat``
    counts each section) by ``path``, ``native`` or ``numpy``."""
    with _lock:
        _counts[fmt][path] += 1


def decode_counts() -> dict:
    """{format: {"native": n, "numpy": m}} since the last reset."""
    with _lock:
        return {f: dict(c) for f, c in _counts.items()}


def reset_counts() -> None:
    with _lock:
        for c in _counts.values():
            c.update(native=0, numpy=0)


def _u8(buf):
    arr = np.frombuffer(buf, np.uint8) if isinstance(
        buf, (bytes, bytearray, memoryview)) else np.ascontiguousarray(
            buf, np.uint8)
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32_out(shape):
    a = np.empty(shape, np.float32)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32(arr):
    a = np.ascontiguousarray(arr, np.int32)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _outputs(n, k_out):
    """(arrays, pointers) of means, scales, quats, colors and sh."""
    outs = [_f32_out(s) for s in ((n, 3), (n, 3), (n, 4), (n, 4),
                                  (n, k_out, 3))]
    return [a for a, _ in outs], [p for _, p in outs]


def parse_splat_native(data):
    """``.splat`` rows -> (means, scales, quats, colors), or None."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(data) // 32
    rows, dp = _u8(data)
    arrays, ptrs = _outputs(n, 0)
    if lib.gs_parse_splat(dp, rows.size, *ptrs[:4]) < 0:
        return None
    record_decode("splat", "native")
    return tuple(arrays[:4])


def parse_ply_inria_v1_native(vertex_data, n: int, stride: int,
                              field_offsets, sh_offsets, k_out: int,
                              coeffs_per_channel: int):
    """An all-f32 vertex block of ``n`` rows of ``stride`` bytes ->
    (means, scales, quats, colors, sh), or None.  ``field_offsets``: the
    byte offsets of x, y, z, scale_0..2, rot_0..3, f_dc_0..2, opacity
    (-1 where absent); ``sh_offsets``: the f_rest fields', channel-major."""
    lib = get_lib()
    if lib is None:
        return None
    # the numpy arrays behind the pointers stay bound until the call ends
    rows, dp = _u8(vertex_data)
    fo, fop = _i32(field_offsets)
    so, sop = _i32(sh_offsets if len(sh_offsets) else [0])
    offs = np.concatenate([fo[fo >= 0], so[:len(sh_offsets)]])
    if (rows.size < n * stride or fo.size != 14 or fo[:3].min() < 0
            or offs.min() < 0 or offs.max() > stride - 4
            or (k_out and (k_out > coeffs_per_channel
                           or len(sh_offsets) < 3 * coeffs_per_channel))):
        raise ValueError("vertex block, field or SH offsets out of range")
    arrays, ptrs = _outputs(n, k_out)
    if lib.gs_parse_ply_inria_v1(dp, n, stride, fop, sop, k_out,
                                 coeffs_per_channel, *ptrs) < 0:
        return None
    record_decode("ply", "native")
    return tuple(arrays)


def parse_ksplat_section_native(rows, n: int, level: int, sh_degree: int,
                                bucket_of, bucket_centers,
                                scale_factor: float, scale_range: int,
                                min_sh: float, max_sh: float):
    """``n`` records of one ``.ksplat`` section -> (means, scales, quats,
    colors, sh), or None.  ``bucket_of`` (each record's bucket) and
    ``bucket_centers`` matter at levels >= 1."""
    lib = get_lib()
    if lib is None:
        return None
    k_out = {0: 0, 1: 3, 2: 8}[sh_degree]
    data, dp = _u8(rows)
    bo, bop = _i32(bucket_of if len(bucket_of) else [0])
    bc = np.ascontiguousarray(bucket_centers, np.float32)
    comp = 3 * k_out                                  # SH floats a record
    bps = 44 + 4 * comp if level == 0 else 24 + (2 if level == 1 else 1) * comp
    if level not in (0, 1, 2) or data.size < n * bps or (
            level and n and (len(bucket_of) < n or bo[:n].min() < 0
                             or bo[:n].max() >= bc.size // 3)):
        raise ValueError("section records or buckets out of range")
    bcp = bc.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) if bc.size else \
        ctypes.cast(None, ctypes.POINTER(ctypes.c_float))
    arrays, ptrs = _outputs(n, k_out)
    if lib.gs_parse_ksplat_section(dp, n, level, sh_degree, bop, bcp,
                                   scale_factor, scale_range, min_sh,
                                   max_sh, *ptrs) < 0:
        return None
    record_decode("ksplat", "native")
    return tuple(arrays)
