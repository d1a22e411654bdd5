"""Utilities: timing registry and spans, leveled logging, config loading,
checkpoint / artifact IO (pure Python/numpy; the timer on the host clock)."""

from . import checkpoint, config, log, timer
from .timer import Timer

__all__ = ["timer", "Timer", "log", "config", "checkpoint"]
