"""Progressive (streaming) scene loading (counterpart of the JAX package's
``io/progressive.py``).

The reference's signature UX: a partially-downloaded buffer is already a
renderable scene whose splat count grows as bytes arrive
(src/loaders/ksplat/KSplatLoader.js:119-180 progressive
watermark load, SplatBuffer.updateLoadedCounts :1038-1048,
PlyLoader.js:89-291 section streaming, splat/SplatLoader.js:26-173).

Formats whose byte layout is a VALID PREFIX (`.ksplat`, `.splat`, and
binary fixed-stride `.ply` once its header has arrived) decode
incrementally — :class:`ProgressiveLoader` accepts chunks and produces
growing ``SplatData`` snapshots; each snapshot decodes the prefix on the
host (the native decoders of ``native`` where they load, else numpy) and
uploads it to ``device`` once, as fresh tensors (there is no
partial-texture upload to emulate).  Formats that need the whole buffer (ascii /
chunked / codebook `.ply` dialects, `.spz` gzip) buffer up and decode once
at the end — the reference's ``DirectLoadError`` downgrade path
(Viewer.js:1302-1308).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.types import SplatData
from .formats import SceneFormat, parse as parse_any, scene_format_from_path

# Decode a fresh snapshot only when at least this many new splats arrived
# (snapshots re-decode the prefix; this bounds total work to ~#snapshots
# passes of the native decoder).
DEFAULT_MIN_NEW_SPLATS = 4096

_SPLAT_ROW_BYTES = 32


class ProgressiveLoader:
    """Incremental decoder over a growing byte prefix.

    Usage::

        loader = ProgressiveLoader.for_path(path)
        for chunk in stream:
            loader.feed(chunk)
            snap = loader.snapshot()      # SplatData or None (no new data)
            ...render snap...
        splats = loader.finalize()
    """

    def __init__(self, fmt: SceneFormat,
                 min_new_splats: int = DEFAULT_MIN_NEW_SPLATS,
                 device="cuda"):
        self.format = fmt
        self.min_new_splats = min_new_splats
        self.device = device
        self._buf = bytearray()
        self._decoded_splats = 0
        self._finalized: Optional[SplatData] = None

    @staticmethod
    def for_path(path: str,
                 min_new_splats: int = DEFAULT_MIN_NEW_SPLATS,
                 device="cuda") -> "ProgressiveLoader":
        return ProgressiveLoader(scene_format_from_path(path), min_new_splats,
                                 device)

    @property
    def supports_incremental(self) -> bool:
        """Whether the stream can produce partial snapshots.

        `.ksplat` / `.splat` always can (valid-prefix layouts).  `.ply` can
        once the header is in the buffer AND it is a binary fixed-stride
        dialect (INRIA V1 / point cloud); ascii and chunk/codebook dialects
        buffer up (the reference's DirectLoadError downgrade).  Before the
        PLY header is complete this is optimistically True (snapshots just
        return None until it arrives).
        """
        if self.format in (SceneFormat.KSplat, SceneFormat.Splat):
            return True
        if self.format == SceneFormat.Ply:
            info = self._ply_stream_info()
            return info is not None or not self._ply_header_complete()
        return False

    def _ply_header_complete(self) -> bool:
        return self._buf.find(b"end_header") >= 0

    def _ply_stream_info(self):
        if not self._ply_header_complete():
            return None
        from .ply import streamable_ply_info
        try:
            return streamable_ply_info(bytes(self._buf))
        except Exception:
            return None

    @property
    def bytes_received(self) -> int:
        return len(self._buf)

    @property
    def decoded_splats(self) -> int:
        return self._decoded_splats

    def feed(self, chunk: bytes) -> None:
        if chunk:
            self._buf.extend(chunk)

    def available_splats(self) -> int:
        """Splats decodable from the current prefix (0 if not incremental)."""
        if not self.supports_incremental:
            return 0
        if self.format == SceneFormat.Splat:
            return len(self._buf) // _SPLAT_ROW_BYTES
        if self.format == SceneFormat.Ply:
            info = self._ply_stream_info()
            if info is None:
                return 0
            header_size, count, stride = info
            return max(0, min(count, (len(self._buf) - header_size) // stride))
        from .ksplat import HEADER_BYTES, SECTION_HEADER_BYTES, \
            _bytes_per_splat, parse_ksplat_header
        if len(self._buf) < HEADER_BYTES:
            return 0
        data = bytes(self._buf)
        header = parse_ksplat_header(data)
        base = HEADER_BYTES + header.max_section_count * SECTION_HEADER_BYTES
        if len(data) < base:
            return 0
        total = 0
        for s in range(header.max_section_count):
            off = HEADER_BYTES + s * SECTION_HEADER_BYTES
            u32 = np.frombuffer(data, "<u4", 10, off)
            u16 = np.frombuffer(data, "<u2", 21, off)
            max_splats = int(u32[1])
            bucket_count = int(u32[3])
            bucket_storage = int(u16[10])
            partial_buckets = int(u32[9])
            sh_degree = int(u16[20])
            bps = _bytes_per_splat(header.compression_level, sh_degree)
            buckets_bytes = (partial_buckets * 4
                             + bucket_storage * bucket_count
                             if header.compression_level >= 1 else 0)
            data_base = base + buckets_bytes
            total += max(0, min(max_splats,
                                (len(data) - data_base) // bps))
            storage = int(u32[7]) or (max_splats * bps + buckets_bytes)
            base += storage
        return total

    def snapshot(self, force: bool = False) -> Optional[SplatData]:
        """Decode the current prefix if enough new splats arrived.

        Returns None when the format cannot stream, nothing new is
        available, or fewer than ``min_new_splats`` arrived (unless
        ``force``).
        """
        if not self.supports_incremental:
            return None
        avail = self.available_splats()
        if avail <= 0:
            return None
        if not force and (avail - self._decoded_splats < self.min_new_splats
                          and self._decoded_splats > 0):
            return None
        if avail == self._decoded_splats and not force:
            return None
        data = bytes(self._buf)
        if self.format == SceneFormat.Splat:
            from .splat import parse_splat
            snap = parse_splat(data[:avail * _SPLAT_ROW_BYTES], self.device)
        elif self.format == SceneFormat.Ply:
            from .ply import parse_ply_inria_v1
            snap = parse_ply_inria_v1(data, max_splats=avail,
                                      device=self.device)
        else:
            from .ksplat import parse_ksplat
            snap = parse_ksplat(data, max_bytes=len(data),
                                device=self.device)
        self._decoded_splats = snap.num_splats
        return snap

    def finalize(self) -> SplatData:
        """Decode the complete buffer (any format)."""
        if self._finalized is None:
            self._finalized = parse_any(bytes(self._buf), self.format,
                                        device=self.device)
            self._decoded_splats = self._finalized.num_splats
        return self._finalized
