""".ply ingest: INRIA V1 gaussian-splat PLY (and plain colored point clouds);
counterpart of the JAX package's ``io/ply.py``.  A binary little-endian
file whose vertex element comes first with all-f32 properties decodes
through the native decoder (``io/native.py``) where it loads; every other
file, or every file without the library, through the numpy columns.

Semantics follow the reference parser
(src/loaders/ply/INRIAV1PlyParser.js:143-207):

- ``scale_i``  -> exp(scale_i)        (0.01 when absent)
- ``f_dc_i``   -> 0.5 + SH_C0 * f_dc  (clamped to [0,1]; or red/green/blue u8)
- ``opacity``  -> sigmoid(opacity)
- ``rot_*``    -> normalized quaternion; PLY order is scalar-first
  (rot_0 = w), stored in SplatData as (x, y, z, w)
- ``f_rest_*`` -> higher-order SH, CHANNEL-major in the file
  (all R coeffs, then G, then B — PlyParserUtils.js:146-157), re-interleaved
  to coefficient-major [N, K, 3] triplets.

The PlayCanvas compressed variant lives in `ply_playcanvas.py`; format
detection dispatches on header contents like the reference's PlyLoader
(src/loaders/ply/PlyLoader.js:107-161).
"""

from __future__ import annotations

import numpy as np

from ..constants import SH_C0
from ..core.types import SplatData
from . import native
from ._arrays import host_arrays, to_splatdata

_HEADER_END = b"end_header"

_PLY_DTYPES = {
    "double": "<f8", "float": "<f4", "int": "<i4", "uint": "<u4",
    "short": "<i2", "ushort": "<u2", "uchar": "u1", "char": "i1",
    "float32": "<f4", "float64": "<f8", "uint8": "u1", "int8": "i1",
    "uint16": "<u2", "int16": "<i2", "uint32": "<u4", "int32": "<i4",
}


class PlyHeader:
    """Parsed PLY header: format, per-element property tables."""

    def __init__(self, fmt, elements, header_size):
        self.format = fmt                  # 'binary_little_endian' | 'ascii' | ...
        self.elements = elements           # list of (name, count, [(prop, type)])
        self.header_size = header_size

    @property
    def vertex(self):
        for name, count, props in self.elements:
            if name == "vertex":
                return count, props
        raise ValueError("PLY has no 'vertex' element")


def parse_ply_header(data: bytes) -> PlyHeader:
    end = data.find(_HEADER_END)
    if not data.startswith(b"ply") or end < 0:
        raise ValueError("not a PLY file (missing magic or end_header)")
    header_size = end + len(_HEADER_END) + 1     # trailing newline
    text = data[:end].decode("ascii", errors="replace")
    fmt = None
    elements = []
    for raw in text.splitlines():
        line = raw.strip()
        if line.startswith("format"):
            fmt = line.split()[1]
        elif line.startswith("element"):
            parts = line.split()
            elements.append((parts[1], int(parts[2]), []))
        elif line.startswith("property"):
            parts = line.split()
            if parts[1] == "list":
                elements[-1][2].append((parts[4], ("list", parts[2], parts[3])))
            else:
                elements[-1][2].append((parts[2], parts[1]))
    return PlyHeader(fmt, elements, header_size)


def detect_ply_variant(data: bytes) -> str:
    """'inria_v1' | 'inria_v2' | 'playcanvas' | 'pointcloud'.

    Mirrors PlyLoader's dispatch: a `chunk` element means PlayCanvas
    (PlayCanvasCompressedPlyParser.js), `codebook_centers` means INRIA V2.
    """
    header = parse_ply_header(data)
    names = [e[0] for e in header.elements]
    if "chunk" in names:
        return "playcanvas"
    if any("codebook" in n for n in names):
        return "inria_v2"
    _, props = header.vertex
    prop_names = [p[0] for p in props]
    if "scale_0" in prop_names or "f_dc_0" in prop_names:
        return "inria_v1"
    return "pointcloud"


def _vertex_recarray(data: bytes, header: PlyHeader) -> np.ndarray:
    count, props = header.vertex
    for _, t in props:
        if isinstance(t, tuple):
            raise ValueError("list properties are not supported in vertex "
                             "elements of splat PLYs")
    if header.format == "ascii":
        body = data[header.header_size:].decode("ascii")
        flat = np.fromiter(map(float, body.split()), np.float64,
                           count=count * len(props))
        table = flat.reshape(count, len(props))
        rec = np.rec.fromarrays(
            [table[:, i] for i in range(len(props))],
            names=",".join(p[0] for p in props))
        return rec
    if header.format != "binary_little_endian":
        raise ValueError(f"unsupported PLY format {header.format}")
    dtype = np.dtype([(name, _PLY_DTYPES[t]) for name, t in props])
    # Preceding elements are not supported before 'vertex' in binary files
    # (the splat PLY dialects put vertex first).
    if header.elements[0][0] != "vertex":
        raise ValueError("binary PLY must have 'vertex' as first element")
    return np.frombuffer(data, dtype=dtype, count=count,
                         offset=header.header_size)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


# the native decoder's field order (csrc/ingest.cpp's field_offsets)
_NATIVE_FIELDS = ("x", "y", "z", "scale_0", "scale_1", "scale_2",
                  "rot_0", "rot_1", "rot_2", "rot_3",
                  "f_dc_0", "f_dc_1", "f_dc_2", "opacity")
# groups the numpy decode reads whole once their first field is there
_NATIVE_GROUPS = (("x", "y", "z"), ("scale_0", "scale_1", "scale_2"),
                  ("rot_0", "rot_1", "rot_2", "rot_3"))


def _quantized_colors(col, names, count):
    """[N, 4] RGBA from the vertex columns (``col(name)``): f_dc through
    SH_C0 (or u8-style red/green/blue), opacity through the sigmoid, each
    floored to a multiple of 1/255."""
    if "f_dc_0" in names:
        rgb = 0.5 + SH_C0 * np.stack([col("f_dc_0"), col("f_dc_1"),
                                      col("f_dc_2")], axis=1)
    elif "red" in names:
        rgb = np.stack([col("red"), col("green"), col("blue")], axis=1) / 255.0
    else:
        rgb = np.zeros((count, 3), np.float32)
    # The reference quantizes to u8 with floor (INRIAV1PlyParser.js:177-181);
    # we keep float colors but clamp identically.
    rgb = np.clip(np.floor(np.clip(rgb, 0, None) * 255.0), 0, 255) / 255.0

    if "opacity" in names:
        op = np.clip(np.floor(_sigmoid(col("opacity")) * 255.0), 0, 255) / 255.0
    else:
        op = np.ones((count,), np.float32)
    return np.concatenate([rgb, op[:, None]], axis=1)


def _try_native_inria_v1(data: bytes, header: PlyHeader, sh_degree):
    """(means, scales, quats, colors, sh) from the native decoder, or None
    where it does not apply: not binary little-endian, the vertex element
    not first, a property not f32, a field group only partly there (the
    numpy decode reads or refuses these its own way), or no library.  A
    body shorter than the header says raises as the numpy decode does."""
    if header.format != "binary_little_endian":
        return None
    if header.elements[0][0] != "vertex":
        return None
    count, props = header.vertex
    offsets = {}
    for i, (name, t) in enumerate(props):
        if t not in ("float", "float32"):
            return None
        offsets[name] = 4 * i
    stride = 4 * len(props)
    for group in _NATIVE_GROUPS:
        there = [f in offsets for f in group]
        if not all(there) and (any(there) or group[0] == "x"):
            return None
    n_rest = sum(1 for p in props if p[0].startswith("f_rest_"))
    cpc = n_rest // 3
    file_deg = 3 if cpc >= 15 else 2 if cpc >= 8 else 1 if cpc >= 3 else 0
    out_deg = file_deg if sh_degree is None else min(sh_degree, file_deg)
    k = {0: 0, 1: 3, 2: 8, 3: 15}[out_deg]
    rest = [f"f_rest_{j}" for j in range(3 * cpc if k else 0)]
    if not all(f in offsets for f in rest):
        return None
    # a view of the vertex block, not a copy
    block = np.frombuffer(data, np.uint8, count * stride, header.header_size)
    return native.parse_ply_inria_v1_native(
        block, count, stride, [offsets.get(f, -1) for f in _NATIVE_FIELDS],
        [offsets[f] for f in rest], k, cpc if k else 1)


def streamable_ply_info(data: bytes):
    """(header_size, vertex_count, row_stride) if ``data``'s header shows a
    prefix-decodable PLY, else None.

    Streamable means: binary little-endian, vertex element first, fixed-size
    properties, INRIA V1 / point-cloud dialect — then any complete-row prefix
    of the body decodes (the layout the reference streams in 256 KiB sections,
    PlyLoader.js:89-291).  Returns None while the header is still incomplete
    or for buffer-up dialects (ascii, PlayCanvas chunks, V2 codebooks, spz).
    """
    if data.find(_HEADER_END) < 0:
        return None
    header = parse_ply_header(data)
    if header.format != "binary_little_endian":
        return None
    if not header.elements or header.elements[0][0] != "vertex":
        return None
    names = [e[0] for e in header.elements]
    if "chunk" in names or any("codebook" in n for n in names):
        return None
    count, props = header.vertex
    stride = 0
    for _, t in props:
        if isinstance(t, tuple):
            return None
        stride += np.dtype(_PLY_DTYPES[t]).itemsize
    return header.header_size, count, stride


def _clamp_vertex_count(header: PlyHeader, max_splats: int) -> PlyHeader:
    elements = [(name, min(count, max_splats) if name == "vertex" else count,
                 props) for name, count, props in header.elements]
    return PlyHeader(header.format, elements, header.header_size)


def parse_ply_inria_v1(data: bytes, sh_degree: int | None = None,
                       max_splats: int | None = None,
                       device="cuda") -> SplatData:
    """Decode an INRIA V1 (or plain point-cloud) PLY buffer.

    ``max_splats`` clamps the decoded vertex count below the header's —
    the progressive-load path decodes the complete rows of a partially
    downloaded body this way (KSplatLoader.js-style watermark streaming
    applied to PLY, PlyLoader.js:89-291).
    """
    header = parse_ply_header(data)
    if max_splats is not None:
        header = _clamp_vertex_count(header, max_splats)
    count, props = header.vertex
    names = {p[0] for p in props}
    decoded = _try_native_inria_v1(data, header, sh_degree)
    if decoded is None:
        native.record_decode("ply", "numpy")
    v = _vertex_recarray(data, header)

    def col(name):
        return np.asarray(v[name], np.float32)

    # Both paths quantize colors here: floor(x * 255) flips where the
    # native decoder's exp or contracted multiply-add rounds the last bit
    # otherwise (a few entries a million), and a scene must not change with
    # the path.
    colors = _quantized_colors(col, names, count)
    if decoded is not None:
        means, scales, quats, _, sh = decoded
        return to_splatdata(means, scales, quats, colors, sh, device)

    means = np.stack([col("x"), col("y"), col("z")], axis=1)

    if "scale_0" in names:
        scales = np.exp(np.stack([col("scale_0"), col("scale_1"),
                                  col("scale_2")], axis=1))
    else:
        scales = np.full((count, 3), 0.01, np.float32)

    if "rot_0" in names:
        q_wxyz = np.stack([col("rot_0"), col("rot_1"), col("rot_2"),
                           col("rot_3")], axis=1)
        q_wxyz /= np.maximum(np.linalg.norm(q_wxyz, axis=1, keepdims=True),
                             1e-12)
        quats = q_wxyz[:, [1, 2, 3, 0]]
    else:
        quats = np.tile(np.array([0, 0, 0, 1], np.float32), (count, 1))

    n_rest = sum(1 for p in props if p[0].startswith("f_rest_"))
    coeffs_per_channel = n_rest // 3
    file_degree = 0
    if coeffs_per_channel >= 3:
        file_degree = 1
    if coeffs_per_channel >= 8:
        file_degree = 2
    if coeffs_per_channel >= 15:
        file_degree = 3
    out_degree = file_degree if sh_degree is None else min(sh_degree,
                                                           file_degree)
    k = {0: 0, 1: 3, 2: 8, 3: 15}[out_degree]
    sh = np.zeros((count, k, 3), np.float32)
    for ch in range(3 if k else 0):
        for i in range(k):
            sh[:, i, ch] = col(f"f_rest_{ch * coeffs_per_channel + i}")
    return to_splatdata(means, scales, quats, colors, sh, device)


def parse_ply(data: bytes, sh_degree: int | None = None,
              device="cuda") -> SplatData:
    variant = detect_ply_variant(data)
    if variant in ("inria_v1", "pointcloud"):
        return parse_ply_inria_v1(data, sh_degree, device=device)
    if variant == "playcanvas":
        from .ply_playcanvas import parse_ply_playcanvas
        return parse_ply_playcanvas(data, sh_degree, device)
    if variant == "inria_v2":
        from .ply_inria_v2 import parse_ply_inria_v2
        return parse_ply_inria_v2(data, sh_degree, device)
    raise ValueError(f"unsupported PLY variant {variant}")


def load_ply(path: str, sh_degree: int | None = None,
             device="cuda") -> SplatData:
    with open(path, "rb") as f:
        return parse_ply(f.read(), sh_degree, device)


def serialize_ply(splats: SplatData) -> bytes:
    """Write an INRIA V1 binary PLY (inverse of the load transforms)."""
    means, scales, quats, colors, sh = host_arrays(splats)
    n, k = means.shape[0], sh.shape[1]

    log_scales = np.log(np.maximum(scales, 1e-12))
    f_dc = (np.clip(colors[:, :3], 0.0, 1.0) - 0.5) / SH_C0
    op = np.clip(colors[:, 3], 1e-6, 1 - 1e-6)
    logit = np.log(op / (1.0 - op))
    q_wxyz = quats[:, [3, 0, 1, 2]]

    fields = (["x", "y", "z", "nx", "ny", "nz",
               "f_dc_0", "f_dc_1", "f_dc_2"]
              + [f"f_rest_{i}" for i in range(3 * k)]
              + ["opacity", "scale_0", "scale_1", "scale_2",
                 "rot_0", "rot_1", "rot_2", "rot_3"])
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n}\n"
              + "".join(f"property float {f}\n" for f in fields)
              + "end_header\n").encode("ascii")

    table = np.zeros((n, len(fields)), np.float32)
    table[:, 0:3] = means
    table[:, 6:9] = f_dc
    base = 9
    for ch in range(3 if k else 0):
        for i in range(k):
            table[:, base + ch * k + i] = sh[:, i, ch]
    base += 3 * k
    table[:, base] = logit
    table[:, base + 1:base + 4] = log_scales
    table[:, base + 4:base + 8] = q_wxyz
    return header + table.astype("<f4").tobytes()


def save_ply(splats: SplatData, path: str) -> None:
    with open(path, "wb") as f:
        f.write(serialize_ply(splats))
