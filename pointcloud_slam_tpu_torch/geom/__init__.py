"""Geometry core: SO(3), S2, SE(3), batched fitting primitives."""

from . import fit, s2, se3, so3
from .se3 import Pose

__all__ = ["so3", "s2", "se3", "fit", "Pose"]
