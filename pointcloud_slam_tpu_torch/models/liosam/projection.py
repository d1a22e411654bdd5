"""Range-image projection, the imageProjection node's role (port of
`pointcloud_slam_tpu/models/liosam/projection.py`).

Reference: `src/jueying_slam/src/imageProjection.cpp` — `projectPointCloud`
(:736-797): an N_SCAN x Horizon_SCAN range image, row from the ring index
(or synthesized from elevation for ringless lidars, :325-461), column from
the horizontal angle; `cloudExtraction` (:799-824) becomes masks.

The image is dense: a scatter-min of the range into one extra drop slot,
then each cell's winner (the point whose range equals the cell's minimum)
writes its coordinates. Where two points of one cell have exactly equal
ranges, which one writes is unspecified here, as in the JAX package.

Rows and columns multiply by float32 reciprocals (`recip32`), as jitted XLA
folds the JAX package's `x / c * H` into `x * (H * (1 / c))`, so a point on a
column bound gets the same column on every device and in jitted JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ...ops.downsample import recip32

_INF = 3.0e38


@dataclasses.dataclass(frozen=True)
class ProjectionConfig:
    n_scan: int = 16                 # N_SCAN (utility.h)
    horizon: int = 1800              # Horizon_SCAN
    fov_up_deg: float = 15.0         # used when no ring channel
    fov_down_deg: float = -15.0
    min_range: float = 1.0           # lidarMinRange
    max_range: float = 1000.0        # lidarMaxRange


class RangeImage(NamedTuple):
    rng: torch.Tensor    # (n_scan, horizon) range, 3e38 where empty
    x: torch.Tensor      # (n_scan, horizon) point coords
    y: torch.Tensor
    z: torch.Tensor
    valid: torch.Tensor  # bool (n_scan, horizon)
    col: torch.Tensor    # column of each input point (N,), -1 invalid
    row: torch.Tensor    # row of each input point (N,)


def rows_from_elevation(cfg: ProjectionConfig, points: torch.Tensor) -> torch.Tensor:
    """Synthesize ring indices from elevation angle (rslidar/velodyne paths,
    imageProjection.cpp:325-461)."""
    r_xy = torch.sqrt(points[0] ** 2 + points[1] ** 2)
    elev = torch.rad2deg(torch.atan2(points[2], r_xy))
    step = (cfg.fov_up_deg - cfg.fov_down_deg) / max(cfg.n_scan - 1, 1)
    return torch.round((elev - cfg.fov_down_deg) * recip32(step)).to(torch.int32)


def project(cfg: ProjectionConfig, points: torch.Tensor, mask: torch.Tensor, rows=None) -> RangeImage:
    """points (3, N) sensor frame -> dense range image."""
    H, S = cfg.horizon, cfg.n_scan
    r = torch.sqrt(torch.sum(points * points, dim=0))
    if rows is None:
        rows = rows_from_elevation(cfg, points)
    ang = torch.atan2(points[1], points[0])  # [-pi, pi]
    col = torch.remainder(torch.floor((math.pi - ang) * recip32(2.0 * math.pi, H)).to(torch.int32), H)
    ok = mask & (r >= cfg.min_range) & (r <= cfg.max_range) & (rows >= 0) & (rows < S)
    flat = torch.where(ok, rows.to(torch.int64) * H + col, S * H)
    img = torch.full((S * H + 1,), _INF, dtype=points.dtype, device=points.device)
    img.scatter_reduce_(0, flat, r, reduce="amin")
    img = img[: S * H]
    # winner-takes-cell payload scatter
    win = ok & (img[torch.clamp(flat, max=S * H - 1)] == r)
    wflat = torch.where(win, flat, S * H)
    pxyz = torch.zeros((3, S * H + 1), dtype=points.dtype, device=points.device)
    pxyz[:, wflat] = points
    pxyz = pxyz[:, : S * H]
    return RangeImage(
        rng=img.reshape(S, H),
        x=pxyz[0].reshape(S, H),
        y=pxyz[1].reshape(S, H),
        z=pxyz[2].reshape(S, H),
        valid=(img < _INF).reshape(S, H),
        col=torch.where(ok, col, -1),
        row=rows,
    )
