"""Config loading and trajectory output (pure Python/numpy)."""

from . import checkpoint, config

__all__ = ["checkpoint", "config"]
