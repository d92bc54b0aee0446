"""Build the port's CUDA kernels and load them through ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), at first use, into ``_build/`` beside this file (git-ignored).
The library's name carries a hash of its source, the ``csrc/`` headers it
includes and the flags, so an edited source or header is rebuilt and a
stale library is never loaded.  ``-Xptxas -v``
reports each kernel's registers, shared memory and spills; the report is
kept beside the library (:func:`ptxas_report`).

The host library of the native scene decoders (``csrc/ingest.cpp``) is
built the same way with ``g++`` (:func:`build_host`); its name also
carries the compiler's version line and the CPU ``-march=native`` resolves
to, so a ``_build/`` copied to another host never loads a library built
for other instructions.

The kernels' entry points are loaded and launched by ``render/launch.py``.

Nothing here runs at import time: this module imports on machines without
``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("composite_fwd", "composite_bwd", "surfel_fwd", "surfel_bwd",
           "kernel_bench", "gather_bwd")
# No --use_fast_math: __expf/__logf would flip the compositor's hard
# thresholds (min_alpha, the 0.999 clamp, the 1e-4 exit).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the JAX package's flags for the same source (its io/native.py)
HOST_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
              "-pthread")

_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the CUDA
    toolkit's default install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _local_headers(src: Path) -> list[Path]:
    """The csrc/ headers ``src`` includes with ``#include "..."``."""
    names = re.findall(r'^\s*#\s*include\s+"([^"]+)"', src.read_text(),
                       flags=re.MULTILINE)
    return [CSRC / n for n in names]


def _paths(name: str) -> tuple[Path, Path, Path]:
    src = CSRC / f"{name}.cu"
    # the headers' bytes too: an edited header must not load a stale build
    text = b"".join(p.read_bytes() for p in [src, *_local_headers(src)])
    digest = hashlib.sha256(
        text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    return src, lib, lib.with_suffix(".ptxas.txt")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists;
    returns the library's path.  Safe to call from several processes: each
    compiles to a private file and renames it into place."""
    src, lib, report = _paths(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    report.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def build_all(names=KERNELS) -> list[Path]:
    """Build every kernel, one ``nvcc`` per source, all started together."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return list(pool.map(build, names))


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(str(build(name)))
    return _libs[name]


def max_active_clusters(name: str, arg: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` of kernel ``name``'s cluster
    instantiation (the one that holds a tile of side 33-64 as 4 blocks):
    how many of its 4-block clusters the current CUDA device holds at
    once.  ``arg``: the channels (3 or 4) for B1-B4; 0 (`full`) for B5
    (``kernel_bench``).  Raises RuntimeError on a CUDA error."""
    from .render.launch import entry
    fn = entry(name, f"{name}_max_clusters",
               (ctypes.c_int, ctypes.POINTER(ctypes.c_int)))
    clusters = ctypes.c_int(0)
    err = fn(arg, ctypes.byref(clusters))
    if err != 0:
        raise RuntimeError(f"{name}: cudaOccupancyMaxActiveClusters failed:"
                           f" CUDA error {err}")
    return clusters.value


def ptxas_report(name: str) -> str:
    """What ``-Xptxas -v`` said when ``name`` was built (registers, shared
    memory, spills), or '' if the library came from an earlier build."""
    _, _, report = _paths(name)
    return report.read_text() if report.exists() else ""


def gxx_path() -> str:
    """``g++`` on the PATH."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH")
    return gxx


@functools.lru_cache(maxsize=None)
def gxx_identity() -> str:
    """``g++ --version``'s first line and the ``-march`` that
    ``-march=native`` resolves to on this CPU: what, besides the source
    and the flags, decides the host library's machine code."""
    gxx = gxx_path()
    version = subprocess.run([gxx, "--version"], capture_output=True,
                             text=True, check=True).stdout.splitlines()[0]
    target = subprocess.run([gxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True).stdout
    march = re.search(r"^\s*-march=\s+(\S+)", target, flags=re.MULTILINE)
    return f"{version} march={march.group(1) if march else '?'}"


def host_lib_path(name: str, build_dir=None, csrc=None) -> Path:
    """Where :func:`build_host` puts ``<csrc>/<name>.cpp``'s library: its
    name hashes the source, :data:`HOST_FLAGS` and :func:`gxx_identity`."""
    src = Path(csrc or CSRC) / f"{name}.cpp"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(HOST_FLAGS).encode()
        + gxx_identity().encode()).hexdigest()[:16]
    return Path(build_dir or BUILD_DIR) / f"lib{name}-{digest}.so"


def build_host(name: str, build_dir=None, csrc=None) -> Path:
    """Compile ``<csrc>/<name>.cpp`` (default ``csrc/``) with ``g++`` into
    ``build_dir`` (default ``_build/``) unless an up-to-date library
    exists; returns its path.  Raises RuntimeError with the compiler's
    output if the build fails.  Safe to call from several processes at
    once: each compiles to a private file and renames it into place."""
    src = Path(csrc or CSRC) / f"{name}.cpp"
    lib = host_lib_path(name, build_dir, csrc)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx_path(), *HOST_FLAGS, str(src), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {src}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib
