"""Streaming fetch with progress + abort (a copy of the JAX package's
``io/fetch.py``) — parity with the reference's
`fetchWithProgress`/`AbortablePromise` (src/Util.js:57-131,
src/AbortablePromise.js:10-71), synchronous-Python style:

- ``fetch_with_progress(url, on_progress, abort_event)`` streams any
  http(s):// or file:// URL (or a plain filesystem path) in 256 KiB chunks
  (Constants.ProgressiveLoadSectionSize), invoking
  ``on_progress(percent, label, chunk, total_bytes)`` per chunk —
  percent is None when the server sends no Content-Length.
- Aborting: set the ``threading.Event``; the fetch raises
  :class:`AbortedError` (the AbortedPromiseError analogue).
"""

from __future__ import annotations

import os
import threading
import urllib.request
from typing import Callable, Optional

from ..constants import PROGRESSIVE_LOAD_SECTION_SIZE

ProgressFn = Callable[[Optional[float], str, bytes, Optional[int]], None]


class AbortedError(RuntimeError):
    """Raised when an abort event fires mid-download."""


def fetch_with_progress(path_or_url: str,
                        on_progress: Optional[ProgressFn] = None,
                        abort_event: Optional[threading.Event] = None,
                        chunk_size: int = PROGRESSIVE_LOAD_SECTION_SIZE,
                        headers: Optional[dict] = None) -> bytes:
    """Fetch a URL or read a file, streaming progress callbacks.

    ``headers``: extra HTTP request headers, like the reference's per-scene
    ``headers`` option (Viewer.js options.headers -> fetchWithProgress).
    """
    is_url = "://" in path_or_url
    if is_url:
        req = urllib.request.Request(path_or_url, headers=headers or {})
        stream = urllib.request.urlopen(req)
        total = stream.headers.get("Content-Length")
        total = int(total) if total else None
    else:
        total = os.path.getsize(path_or_url)
        stream = open(path_or_url, "rb")

    chunks = []
    read = 0
    try:
        while True:
            if abort_event is not None and abort_event.is_set():
                raise AbortedError(f"fetch of {path_or_url} aborted")
            chunk = stream.read(chunk_size)
            if not chunk:
                break
            chunks.append(chunk)
            read += len(chunk)
            if on_progress is not None:
                if total:
                    pct = read / total * 100.0
                    on_progress(pct, f"{pct:.2f}%", chunk, total)
                else:
                    on_progress(None, "", chunk, None)
    finally:
        stream.close()
    if on_progress is not None:
        on_progress(100.0, "100%", b"", total)
    return b"".join(chunks)
