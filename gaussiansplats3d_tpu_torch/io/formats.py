"""Format detection + load/save dispatch (the PlyLoader/SceneFormat layer);
counterpart of the JAX package's ``io/formats.py``.

Mirrors the reference's src/loaders/Utils.js:3-9 (sceneFormatFromPath) and
the per-format loaders' entry points.  URL fetch is not ported: a URL
raises ``NotImplementedError``.
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
         format: "SceneFormat | None" = None, device="cuda") -> SplatData:
    """Load any supported scene file into SplatData on ``device``.

    ``sh_degree`` optionally truncates higher-order SH at load time (the
    reference's outSphericalHarmonicsDegree parameter).  ``format``
    overrides extension sniffing, like the reference's per-scene ``format``
    option (Viewer.js addSplatScene options).
    """
    if "://" in path:
        raise NotImplementedError(
            "loading from a URL is not ported (io/fetch.py); download the "
            "file and load its path")
    fmt = format if format is not None else scene_format_from_path(path)
    with open(path, "rb") as f:
        return parse(f.read(), fmt, sh_degree, device)


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
