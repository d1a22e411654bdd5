"""Models: LIO odometry, LIO-SAM SLAM and prior-map localization."""

from . import liosam, lio, localization

__all__ = ["lio", "liosam", "localization"]
