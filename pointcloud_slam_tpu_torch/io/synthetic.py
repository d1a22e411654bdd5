"""Synthetic LiDAR world / scan / IMU generators for tests and benchmarks.

Numpy-only copies of the generators in `pointcloud_slam_tpu/io/synthetic.py`
(that module cannot be imported without jax): the same seeds give the same
worlds, trajectories and scans, so the port and the JAX package can be fed
identical data. `simulate_lio_sequence` builds its frames with this
package's `feed.make_frame` on the requested device.
"""

from __future__ import annotations

import numpy as np


def make_room_cloud(n_points: int, seed: int = 0, size: float = 20.0, noise: float = 0.005) -> np.ndarray:
    """Points sampled on the 6 faces of a box plus a few interior walls."""
    rng = np.random.default_rng(seed)
    s = size / 2
    # face: (origin, u axis, v axis)
    faces = [
        ((-s, -s, 0.0), (1, 0, 0), (0, 1, 0)),   # floor
        ((-s, -s, 3.0), (1, 0, 0), (0, 1, 0)),   # ceiling
        ((-s, -s, 0.0), (1, 0, 0), (0, 0, 1)),   # wall y=-s
        ((-s, s, 0.0), (1, 0, 0), (0, 0, 1)),    # wall y=+s
        ((-s, -s, 0.0), (0, 1, 0), (0, 0, 1)),   # wall x=-s
        ((s, -s, 0.0), (0, 1, 0), (0, 0, 1)),    # wall x=+s
        ((-s / 2, -s, 0.0), (0, 1, 0), (0, 0, 1)),  # interior wall 1
        ((0.0, 0.0, 0.0), (1, 0, 0), (0, 0, 1)),    # interior wall 2
    ]
    per = n_points // len(faces)
    pts = []
    for k, (o, u, v) in enumerate(faces):
        m = per if k < len(faces) - 1 else n_points - per * (len(faces) - 1)
        uu = rng.uniform(0, size, size=(m, 1))
        vv = rng.uniform(0, 3.0 if u[2] == 0 and v[2] == 1 else size, size=(m, 1))
        vv = np.where(np.asarray(v)[2] == 1, np.clip(vv, 0, 3.0), vv % size)
        p = np.asarray(o) + uu * np.asarray(u) + vv * np.asarray(v)
        pts.append(p)
    cloud = np.concatenate(pts, axis=0)
    cloud = np.clip(cloud, -s, s)
    cloud += rng.normal(scale=noise, size=cloud.shape)
    return cloud.astype(np.float32)


def make_scan_from_world(world: np.ndarray, sensor_pos: np.ndarray, max_range: float = 30.0, seed: int = 0,
                         n_out: int | None = None) -> np.ndarray:
    """Range-gated view of the world from a sensor position, in the SENSOR frame
    (identity orientation). Subsamples to n_out points if given."""
    rng = np.random.default_rng(seed)
    rel = world - sensor_pos[None, :]
    r = np.linalg.norm(rel, axis=1)
    vis = rel[(r < max_range) & (r > 0.3)]
    if n_out is not None:
        idx = rng.choice(len(vis), size=min(n_out, len(vis)), replace=len(vis) < n_out)
        vis = vis[idx]
    return vis.astype(np.float32)


def random_pose(seed: int = 0, rot_scale: float = 0.1, trans_scale: float = 0.5):
    """Small random SE(3) perturbation as (R, t) numpy pair."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=3)
    w = w / np.linalg.norm(w) * rng.uniform(0, rot_scale)
    t = rng.normal(size=3)
    t = t / np.linalg.norm(t) * rng.uniform(0, trans_scale)
    theta = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if theta < 1e-12:
        R = np.eye(3)
    else:
        K = K / theta
        R = np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * K @ K
    return R.astype(np.float32), t.astype(np.float32)


def make_imu_trajectory(
    n_frames: int,
    imu_per_frame: int = 20,
    frame_dt: float = 0.1,
    seed: int = 0,
    gravity: float = 9.809,
    still_frames: int = 2,
    acc_amp: float = 1.0,
    yaw_rate_amp: float = 0.4,
):
    """Discrete-exact trajectory with IMU measurements: ground truth is defined
    by the filter's own first-order integration rule, so IMU integration is
    exact by construction. Stationary for `still_frames` frames."""
    rng = np.random.default_rng(seed)
    n = n_frames * imu_per_frame + 1
    dt = frame_dt / imu_per_frame
    t = np.arange(n) * dt
    t_still = still_frames * frame_dt
    ramp = np.clip((t - t_still) / max(frame_dt, 1e-6), 0.0, 1.0)
    env = ramp * ramp * (3 - 2 * ramp)  # smoothstep

    freq = rng.uniform(0.2, 0.5, size=3)
    phase = rng.uniform(0, 2 * np.pi, size=3)
    acc_w = (acc_amp * np.sin(2 * np.pi * freq * t[:, None] + phase)) * env[:, None]
    yaw_rate = yaw_rate_amp * np.sin(2 * np.pi * 0.3 * t) * env

    grav_w = np.array([0.0, 0.0, -gravity])
    pos = np.zeros((n, 3))
    vel = np.zeros((n, 3))
    R = np.zeros((n, 3, 3))
    R[0] = np.eye(3)
    acc_b = np.zeros((n, 3), np.float32)
    gyro_b = np.zeros((n, 3), np.float32)
    for i in range(n - 1):
        acc_b[i] = R[i].T @ (acc_w[i] - grav_w)
        gyro_b[i] = np.array([0.0, 0.0, yaw_rate[i]])
        pos[i + 1] = pos[i] + vel[i] * dt
        vel[i + 1] = vel[i] + acc_w[i] * dt
        th = yaw_rate[i] * dt
        dR = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
        R[i + 1] = R[i] @ dR
    acc_b[-1] = R[-1].T @ (acc_w[-1] - grav_w)
    gyro_b[-1] = np.array([0.0, 0.0, yaw_rate[-1]])
    return {
        "t": t.astype(np.float64),
        "acc": acc_b.astype(np.float32),
        "gyro": gyro_b.astype(np.float32),
        "pos": pos.astype(np.float32),
        "vel": vel.astype(np.float32),
        "R": R.astype(np.float32),
        "imu_per_frame": imu_per_frame,
        "frame_dt": frame_dt,
    }


def simulate_lio_sequence(n_frames=40, n_pts=3000, imu_per_frame=20, frame_dt=0.1, seed=0, device="cuda"):
    """Synthetic world + trajectory + exact IMU -> (world, traj, [(frame, gt_pos, gt_R)]).

    Frame f applies IMU samples i0..i1-1 stamped at their interval ENDS; the
    scan is taken at the frame-end pose."""
    from . import feed

    world = make_room_cloud(40000, seed=seed)
    traj = make_imu_trajectory(n_frames, imu_per_frame, frame_dt, seed=seed)
    frames = []
    rng = np.random.default_rng(seed)
    for f in range(n_frames):
        i0 = f * imu_per_frame
        i1 = (f + 1) * imu_per_frame
        pos, R = traj["pos"][i1], traj["R"][i1]
        rel = (world - pos) @ R  # world -> body
        r = np.linalg.norm(rel, axis=1)
        vis = rel[(r < 25.0) & (r > 0.3)]
        idx = rng.choice(len(vis), size=min(n_pts, len(vis)), replace=False)
        pts = vis[idx].astype(np.float32)
        t_offs = np.full(len(pts), frame_dt, np.float32)
        imu_t = (traj["t"][i0 + 1 : i1 + 1] - traj["t"][i0]).astype(np.float32)
        fr = feed.make_frame(
            pts, t_offs, traj["acc"][i0:i1], traj["gyro"][i0:i1], imu_t,
            n_points=n_pts, n_imu=imu_per_frame, prev_imu_t=0.0, device=device,
        )
        frames.append((fr, pos, R))
    return world, traj, frames
