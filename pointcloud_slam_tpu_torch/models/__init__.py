"""Models (first slice: LIO odometry)."""

from . import lio

__all__ = ["lio"]
