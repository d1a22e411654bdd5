"""Prior-map localization (tile maps, LOAM/NDT matching, loss detection)."""

from .pipeline import LocalizationConfig, LocalizationResult, localize_loam, localize_ndt, relocalize

__all__ = ["LocalizationConfig", "LocalizationResult", "localize_loam", "localize_ndt", "relocalize"]
