"""Host-side sensor feed and synthetic data (numpy), producing tensors for the device."""

from . import feed, synthetic

__all__ = ["feed", "synthetic"]
