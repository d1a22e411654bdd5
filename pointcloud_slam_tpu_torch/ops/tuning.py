"""Scan-density-driven grid auto-tuning (the PyTorch port's copy of
`pointcloud_slam_tpu/ops/tuning.py`, onto the port's `GridConfig`).

The reference couples map resolution and kNN stencil width to the lidar:
each shipped YAML hand-picks `ivox_grid_resolution` / `ivox_nearby_type` per
sensor (src/jueying_lio/config/*.yaml — e.g. 0.5/faces for dense Livox,
1.0/wider for 16-ring Velodyne), and our oracle-trajectory test documents the
failure mode when they mismatch (sparse scans + fine voxels = empty stencils,
no plane fits). This module turns that hand-tuning into a measurement:

  1. `estimate_spacing` — median nearest-neighbor distance of a scan sample
     (the native C++ oracle's exact kNN; host-side, tiny).
  2. `suggest_grid` — a GridConfig whose voxel edge gives the plane fit
     enough support: lidar returns sample 2-D surfaces, so a voxel of edge r
     holds ~(r/s)^2 points at spacing s; r = s*sqrt(2*num_match) targets
     ~2x the 5-NN requirement, and the stencil widens when the spacing is so
     coarse that the center voxel alone cannot carry the fit.

Host-side (numpy + the native oracle): meant to run once per session/config,
not inside the frame loop. Tensors on any device are read back first.
"""

from __future__ import annotations

import numpy as np
import torch

from .voxel_grid import GridConfig


def estimate_spacing(points: np.ndarray, mask=None, sample: int = 2048, seed: int = 0) -> float:
    """Median nearest-neighbor distance [m] of a masked (3, N) or (N, 3) scan."""
    from .. import native

    if torch.is_tensor(points):
        points = points.detach().cpu().numpy()
    if torch.is_tensor(mask):
        mask = mask.detach().cpu().numpy()
    pts = np.asarray(points)
    if pts.shape[0] == 3 and pts.shape[1] != 3:
        pts = pts.T
    if mask is not None:
        pts = pts[np.asarray(mask, bool)]
    pts = pts[np.isfinite(pts).all(axis=1)]
    if len(pts) < 8:
        return 0.1
    rng = np.random.default_rng(seed)
    q = pts[rng.choice(len(pts), size=min(sample, len(pts)), replace=False)]
    # 2-NN because each query is its own nearest neighbor at distance 0
    _, d2 = native.knn(pts.astype(np.float64), q.astype(np.float64), k=2)
    d = np.sqrt(np.maximum(d2[:, 1], 0.0))
    return float(np.median(d[np.isfinite(d)]))


def suggest_grid(
    points: np.ndarray,
    mask=None,
    capacity: int = 1 << 17,
    pts_per_voxel: int = 8,
    num_match: int = 5,
    min_resolution: float = 0.2,
    max_resolution: float = 2.0,
    aggressive: bool = False,
) -> GridConfig:
    """GridConfig sized to the scan's measured point spacing.

    resolution = spacing * sqrt(2*num_match), clipped to the range the
    reference's per-lidar configs span (0.2..2.0 m). Measured on a
    10x-decimated synthetic scan (the failure mode test_oracle_trajectory
    documents): the dense-lidar default (0.4 m, faces stencil) finds 5
    neighbors for only 13% of points; the suggested resolution alone lifts
    that to 79%, and the 19-voxel stencil to 92% — surface sampling puts
    ~(res/spacing)^2 ~ 2*num_match points per voxel, so the center+faces
    stencil alone has little margin at ANY scale. The suggestion is
    robustness-first (edges stencil); pass aggressive=True for the
    faces-only stencil when a hand-tuned YAML is known to match the lidar
    (the reference equally ships per-lidar `ivox_nearby_type`)."""
    s = estimate_spacing(points, mask)
    res = float(np.clip(s * np.sqrt(2.0 * num_match), min_resolution, max_resolution))
    return GridConfig(
        capacity=capacity, pts_per_voxel=pts_per_voxel, resolution=round(res, 3),
        nearby=7 if aggressive else 19,
    )
