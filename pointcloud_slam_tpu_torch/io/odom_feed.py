"""External odometry feeds (UKF / GPS) for the localization pipeline (a copy
of `pointcloud_slam_tpu/io/odom_feed.py`).

Behavioral parity target: `src/jueying_slam/src/localization.cpp`
  - `UKFHandler` (:482-495): an external UKF odometry stream continuously
    refreshes `initialPose` with the lever-arm-corrected position
    Pwl = Pwi + Qwi * Pil, so relocalization-on-loss (:441-476) re-seeds
    from the robot's LATEST fused pose rather than the static start pose.
  - `gpsHandler` (:499-520): one-shot GPS initialization gated on
    covariance[0] < 0.003 && covariance[7] < 0.003 and a nonzero fix, with
    the same lever-arm correction.

Host-side (numpy): these run at message rate on the ingest thread in the
reference; nothing here belongs on the GPU.
"""

from __future__ import annotations

import numpy as np

GPS_COV_GATE = 0.003  # localization.cpp:507 covariance gate


def _quat_to_mat(qw, qx, qy, qz):
    n = max(np.sqrt(qw * qw + qx * qx + qy * qy + qz * qz), 1e-12)
    qw, qx, qy, qz = qw / n, qx / n, qy / n, qz / n
    return np.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
        ],
        np.float64,
    )


class UkfOdomFeed:
    """Replays an external odometry stream (t, x, y, z, qw, qx, qy, qz rows)
    and serves the lever-arm-corrected lidar-frame position at any stamp —
    the UKFHandler role. `lever_arm` is Pil (lidar origin in the IMU/body
    frame, localization.cpp:490)."""

    def __init__(self, rows: np.ndarray, lever_arm=(0.0, 0.0, 0.0)):
        rows = np.atleast_2d(np.asarray(rows, np.float64))
        if rows.shape[1] < 8:
            pad = np.zeros((len(rows), 8 - rows.shape[1]))
            pad[:, 0] = 1.0  # identity quaternion (qw first)
            rows = np.concatenate([rows, pad], axis=1)
        self.rows = rows[np.argsort(rows[:, 0], kind="stable")]
        self.pil = np.asarray(lever_arm, np.float64)
        self.initialized = len(self.rows) > 0  # ukf_initialized flag (:484)

    @classmethod
    def from_csv(cls, path: str, lever_arm=(0.0, 0.0, 0.0)) -> "UkfOdomFeed":
        rows = np.loadtxt(path, delimiter=",", ndmin=2)
        return cls(rows, lever_arm)

    def initial_pose_at(self, stamp: float):
        """Latest lever-arm-corrected position (and yaw) at or before `stamp`.

        Returns (pos (3,), yaw) or None before the first message — matching
        that relocalization only uses initialPose once ukf_initialized."""
        if not self.initialized:
            return None
        i = int(np.searchsorted(self.rows[:, 0], stamp, side="right")) - 1
        if i < 0:
            return None
        t, x, y, z, qw, qx, qy, qz = self.rows[i, :8]
        R = _quat_to_mat(qw, qx, qy, qz)
        pwl = np.array([x, y, z]) + R @ self.pil
        yaw = float(np.arctan2(R[1, 0], R[0, 0]))
        return pwl.astype(np.float32), yaw


def gps_init_position(gps_xyz, gps_cov_xy, quat=None, lever_arm=(0.0, 0.0, 0.0)):
    """One-shot GPS initial position with the reference's acceptance gate
    (gpsHandler :499-520): nonzero fix AND both horizontal covariances under
    GPS_COV_GATE. Returns the lever-arm-corrected (3,) position or None."""
    x, y, z = (float(v) for v in gps_xyz)
    cx, cy = (float(v) for v in gps_cov_xy)
    if (x == 0.0 and y == 0.0) or cx >= GPS_COV_GATE or cy >= GPS_COV_GATE:
        return None
    R = _quat_to_mat(*(quat if quat is not None else (1.0, 0.0, 0.0, 0.0)))
    return (np.array([x, y, z]) + R @ np.asarray(lever_arm, np.float64)).astype(np.float32)
