"""Registration (first slice: VGICP source covariances)."""

from . import vgicp
from .vgicp import source_covariances

__all__ = ["vgicp", "source_covariances"]
