"""LogLevel-gated logging — parity with the reference's LogLevel enum
gating console output (the reference's src/LogLevel.js, used e.g. at
Viewer.js:1268-1294, SplatMesh.js:247-275); counterpart of the JAX
package's ``utils/logging.py``, with a logger of its own name."""

from __future__ import annotations

import logging
import sys

from ..viewer.enums import LogLevel

_LEVEL_MAP = {
    LogLevel.NONE: logging.CRITICAL + 10,
    LogLevel.ERROR: logging.ERROR,
    LogLevel.WARNING: logging.WARNING,
    LogLevel.INFO: logging.INFO,
    LogLevel.DEBUG: logging.DEBUG,
}

_logger = logging.getLogger("gaussiansplats3d_tpu_torch")
if not _logger.handlers:
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(
        "[%(name)s %(levelname)s] %(message)s"))
    _logger.addHandler(handler)
    _logger.setLevel(logging.WARNING)
    _logger.propagate = False


def get_logger() -> logging.Logger:
    return _logger


def set_log_level(level: LogLevel | int) -> None:
    """Set verbosity with the reference's LogLevel values."""
    if isinstance(level, LogLevel):
        level = _LEVEL_MAP[level]
    _logger.setLevel(level)
