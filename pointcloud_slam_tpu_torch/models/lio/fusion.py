"""High-rate pose output: IMU-rate forward prediction between LIO updates
(port of `pointcloud_slam_tpu/models/lio/fusion.py`).

Reference `src/jueying_slam/src/imuPreintegration.cpp`:
`TransformFusion::imuOdometryHandler` (:23-150) fuses the low-rate lidar
odometry with IMU-rate increments, and `IMUPreintegration::imuHandler`
(:460+) predicts forward from the last optimized state per IMU sample.

The JAX package's `lax.scan` over the samples is a loop of device ops here;
nothing reads back to the host.
"""

from __future__ import annotations

import torch

from ...geom import so3
from . import state as st


def predict_poses(x: st.NavState, imu_acc, imu_gyro, imu_dt, imu_mask, acc_scale=1.0):
    """Forward-predict IMU-rate poses from the last filter state (no covariance).

    imu_* are (M, 3) / (M,). Returns (R (M, 3, 3), pos (M, 3), vel (M, 3)),
    the odomTopic_incremental stream; a masked-out sample repeats the last pose.
    """
    rot, pos, vel = x.rot, x.pos, x.vel
    Rs, ps, vs = [], [], []
    for i in range(imu_acc.shape[0]):
        dt, m = imu_dt[i], imu_mask[i]
        a_w = rot @ (imu_acc[i] * acc_scale - x.ba) + x.grav
        rot_n = rot @ so3.exp((imu_gyro[i] - x.bg) * dt)
        pos, vel, rot = torch.where(m, pos + vel * dt, pos), torch.where(m, vel + a_w * dt, vel), torch.where(m, rot_n, rot)
        Rs.append(rot)
        ps.append(pos)
        vs.append(vel)
    return torch.stack(Rs), torch.stack(ps), torch.stack(vs)


def fuse_with_update(R_hi, p_hi, R_old_anchor, p_old_anchor, R_new_anchor, p_new_anchor):
    """Rebase a high-rate pose block onto a freshly optimized anchor pose
    (TransformFusion: lidar-odom pose x incremental-odom delta): for each
    T_hi recorded relative to the old anchor, T_new_anchor * T_old_anchor^-1 * T_hi."""
    dR = R_new_anchor @ R_old_anchor.transpose(-1, -2)
    dp = p_new_anchor - torch.einsum("ij,...j->...i", dR, p_old_anchor)
    R_out = torch.einsum("ij,mjk->mik", dR, R_hi)
    p_out = torch.einsum("ij,mj->mi", dR, p_hi) + dp
    return R_out, p_out
