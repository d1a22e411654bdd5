"""Utilities: timing registry, leveled logging, config loading, checkpoint /
artifact IO (pure Python/numpy, CUDA events for the timer)."""

from . import checkpoint, config, log, timer
from .timer import Timer

__all__ = ["timer", "Timer", "log", "config", "checkpoint"]
