"""Host-side sensor feed: packs raw scans + IMU into fixed-shape LIOFrames
(port of `pointcloud_slam_tpu/io/feed.py`; reference laser_mapping.cc:391-518
SyncPackages). Padding and masking happen here on the host (numpy); the
frame's tensors are created on the requested device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.lio.pipeline import LIOFrame


def make_frame(
    pts: np.ndarray,        # (P, 3) lidar points (lidar frame)
    t_offs: np.ndarray,     # (P,) point offsets from scan start [s]
    imu_acc: np.ndarray,    # (K, 3)
    imu_gyro: np.ndarray,   # (K, 3)
    imu_t: np.ndarray,      # (K,) sample times relative to scan start [s]
    n_points: int,
    n_imu: int,
    prev_imu_t: Optional[float] = None,
    device="cuda",
) -> LIOFrame:
    """Pad/truncate a raw frame to the static (n_points, n_imu) shapes."""
    P = len(pts)
    if P > n_points:
        keep = np.random.default_rng(0).choice(P, n_points, replace=False)
        pts, t_offs = pts[keep], t_offs[keep]
        P = n_points
    pts_p = np.zeros((3, n_points), np.float32)
    pts_p[:, :P] = pts.T
    mask = np.zeros(n_points, bool)
    mask[:P] = True
    t_p = np.zeros(n_points, np.float32)
    t_p[:P] = t_offs

    K = len(imu_t)
    if K > n_imu:
        raise ValueError(f"frame has {K} IMU samples > capacity {n_imu}")
    acc_p = np.zeros((n_imu, 3), np.float32)
    gyr_p = np.zeros((n_imu, 3), np.float32)
    dt_p = np.zeros(n_imu, np.float32)
    offs_p = np.full(n_imu, 1e9, np.float32)  # padding sorts last in the interval search
    imask = np.zeros(n_imu, bool)
    if K:
        acc_p[:K] = imu_acc
        gyr_p[:K] = imu_gyro
        offs_p[:K] = imu_t
        prev = prev_imu_t if prev_imu_t is not None else (imu_t[0] - 0.005)
        dt_p[:K] = np.diff(np.concatenate([[prev], imu_t])).astype(np.float32)
        imask[:K] = True

    def dev(a):
        return torch.from_numpy(a).to(device)

    return LIOFrame(
        pts=dev(pts_p),
        pt_mask=dev(mask),
        t_offs=dev(t_p),
        imu_acc=dev(acc_p),
        imu_gyro=dev(gyr_p),
        imu_dt=dev(dt_p),
        imu_offs=dev(offs_p),
        imu_mask=dev(imask),
    )
