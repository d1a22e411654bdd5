"""Lidar preprocessing: blind filter, decimation, time synthesis (port of
`pointcloud_slam_tpu/models/lio/preprocess.py`).

Reference: `src/jueying_lio/src/pointcloud_preprocess.cc`
  - `AviaHandler` (:14-80): Livox CustomMsg tag filter (spatial tag bits
    0x30 == 0x10/0x00), 1/N decimation, blind range,
  - `VelodyneHandler` / `RslidarHandler` (:150-305): point time synthesized
    from azimuth when the format carries no per-point timestamps,
  - blind-range filter (`blind * blind > x^2+y^2+z^2` drop).

Device side: `apply_masks`, mask ops on (3, N) tensors on their own device.
Host side: numpy field decoding for the converter layer `io.converters`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    blind: float = 0.1               # blind range [m]
    point_filter_num: int = 1        # keep every n-th point
    max_range: float = 150.0
    num_scans: int = 6               # lidar lines (AVIA 6)


def apply_masks(cfg: PreprocessConfig, points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Blind range + max range + 1/N decimation of the surviving points."""
    d2 = torch.sum(points * points, dim=0)
    m = mask & (d2 > cfg.blind * cfg.blind) & (d2 < cfg.max_range * cfg.max_range)
    idx = torch.cumsum(m.to(torch.int32), dim=0) - 1
    return m & (idx % cfg.point_filter_num == 0)


def avia_tag_filter(tags: np.ndarray) -> np.ndarray:
    """Livox tag gating: spatial tag bits (4:5) must be 0x10 or 0x00
    (pointcloud_preprocess.cc:31)."""
    sp = tags & 0x30
    return (sp == 0x10) | (sp == 0x00)


def synthesize_velodyne_times(points_xyz: np.ndarray, rings: np.ndarray, scan_rate_hz: float = 10.0) -> np.ndarray:
    """Relative point time [s] from azimuth when the format has no timestamps
    (VelodyneHandler :150-220: omega scan angular velocity, per-ring unwrap)."""
    yaw = np.degrees(np.arctan2(points_xyz[:, 1], points_xyz[:, 0]))
    omega = 360.0 * scan_rate_hz  # deg/s
    t = np.zeros(len(points_xyz), np.float64)
    for r in np.unique(rings):
        sel = np.where(rings == r)[0]
        y = yaw[sel]
        t[sel] = ((y[0] - y) % 360.0) / omega  # clockwise scan
    return t.astype(np.float32)
