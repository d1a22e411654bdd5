"""Trajectory output (copy of `pointcloud_slam_tpu/utils/checkpoint.py::save_trajectory_tum`)."""

from __future__ import annotations


def save_trajectory_tum(path: str, times, positions, quats_xyzw):
    """TUM format: t x y z qx qy qz qw (laser_mapping.cc Savetrajectory)."""
    with open(path, "w") as f:
        for t, p, q in zip(times, positions, quats_xyzw):
            f.write(f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")
