"""Format detection + load/save dispatch (the PlyLoader/SceneFormat layer);
counterpart of the JAX package's ``io/formats.py``.

Mirrors the reference's src/loaders/Utils.js:3-9 (sceneFormatFromPath) and
the per-format loaders' entry points.
"""

from __future__ import annotations

import enum
import os

from ..core.types import SplatData


class SceneFormat(enum.Enum):
    Ply = "ply"
    Splat = "splat"
    KSplat = "ksplat"
    Spz = "spz"


def scene_format_from_path(path: str) -> SceneFormat:
    ext = os.path.splitext(path)[1].lower().lstrip(".")
    try:
        return SceneFormat(ext)
    except ValueError:
        raise ValueError(f"unrecognized scene file extension '.{ext}' "
                         f"(supported: ply, splat, ksplat, spz)") from None


def load(path: str, sh_degree: int | None = None,
         on_progress=None, abort_event=None,
         format: "SceneFormat | None" = None,
         headers: dict | None = None, device="cuda") -> SplatData:
    """Load any supported scene file or URL into SplatData on ``device``.

    ``sh_degree`` optionally truncates higher-order SH at load time (the
    reference's outSphericalHarmonicsDegree parameter).  ``on_progress`` /
    ``abort_event`` stream download progress (io.fetch.fetch_with_progress,
    the fetchWithProgress parity surface) — used for URLs and large files.
    ``format`` overrides extension sniffing and ``headers`` adds HTTP
    request headers, like the reference's per-scene ``format``/``headers``
    options (Viewer.js addSplatScene options).
    """
    is_url = "://" in path
    base = path.split("?")[0] if is_url else path
    fmt = format if format is not None else scene_format_from_path(base)
    if (is_url or on_progress is not None or abort_event is not None
            or headers is not None):
        from .fetch import fetch_with_progress
        data = fetch_with_progress(path, on_progress, abort_event,
                                   headers=headers)
    else:
        with open(path, "rb") as f:
            data = f.read()
    return parse(data, fmt, sh_degree, device)


def parse(data: bytes, fmt: SceneFormat, sh_degree: int | None = None,
          device="cuda") -> SplatData:
    """Decode a complete in-memory buffer of the given format."""
    if fmt == SceneFormat.Ply:
        from .ply import parse_ply
        return parse_ply(data, sh_degree, device)
    if fmt == SceneFormat.Splat:
        from .splat import parse_splat
        out = parse_splat(data, device)
    elif fmt == SceneFormat.KSplat:
        from .ksplat import parse_ksplat
        out = parse_ksplat(data, device=device)
    else:
        from .spz import parse_spz
        return parse_spz(data, sh_degree, device)
    if sh_degree is not None and out.sh_degree > sh_degree:
        out = out.with_sh_degree(sh_degree)
    return out


def save(splats: SplatData, path: str, **kw) -> None:
    """Save SplatData (on any device) in the format implied by the file
    extension."""
    fmt = scene_format_from_path(path)
    if fmt == SceneFormat.Ply:
        from .ply import save_ply
        save_ply(splats, path)
    elif fmt == SceneFormat.Splat:
        from .splat import save_splat
        save_splat(splats, path)
    elif fmt == SceneFormat.KSplat:
        from .ksplat import save_ksplat
        save_ksplat(splats, path, **kw)
    else:
        from .spz import save_spz
        save_spz(splats, path, **kw)
