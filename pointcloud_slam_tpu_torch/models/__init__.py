"""Models: LIO odometry and LIO-SAM SLAM."""

from . import liosam, lio

__all__ = ["lio", "liosam"]
