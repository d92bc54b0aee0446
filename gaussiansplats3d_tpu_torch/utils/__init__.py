"""Cross-cutting utilities: logging, metrics, profiling, image quality."""

from .logging import get_logger, set_log_level  # noqa: F401
from .metrics import FrameStats, Timer, profile_trace, timed_render  # noqa: F401
