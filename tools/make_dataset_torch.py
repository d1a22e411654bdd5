#!/usr/bin/env python
"""Write replay datasets in the reference's input formats, with the PyTorch
port's own readers and writers (no jax): the two modes of
`tools/make_dataset.py`, byte for byte the same files for the same seed.

`kitti`: a KITTI odometry sequence directory, `velodyne/%06d.bin` (float32
x, y, z, intensity records, fast_gicp/src/kitti.cpp:31-44), the ground
truth `poses.txt` (KITTI 3x4 row-major) and a `calib.txt` stub: a street
block with a rectangular vehicle circuit (numpy, copied from the JAX tool).

`lio` (the default): the dataset directory holds `frame_%06d.pcd` (XYZ + intensity + ring +
per-point `time`; motion-distorted: each point is generated from the true
sensor pose at its own timestamp), `imu.csv` (t, ax, ay, az, gx, gy, gz),
`scan_times.txt` and `gt_traj.txt` (TUM). With `--bag` the same sequence is
also written as `data.bag`: Livox CustomMsg scans on `/livox/lidar` and
sensor_msgs/Imu on `/imu/data`, uncompressed.

    python tools/make_dataset_torch.py --out build/lio_seq --frames 20 --bag
    python tools/make_dataset_torch.py kitti --out build/kitti_seq --frames 60
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def _to_quat(R):
    w = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    if w < 1e-9:
        return np.array([0.0, 0.0, 0.0, 1.0])
    return np.array([(R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
                     (R[1, 0] - R[0, 1]) / (4 * w), w])


def make_street_world(seed=0, n_points=400_000):
    """Street-block world: ground, building facades on both sides of a
    rectangular circuit, scattered poles. Returns (N, 3) float32."""
    rng = np.random.default_rng(seed)
    pts = []
    L = 120.0   # circuit side length
    W = 14.0    # street width
    # ground: ring-shaped street area around the block
    n_g = n_points // 3
    t = rng.uniform(0, 4, n_g)
    side = np.floor(t).astype(int)
    u = (t - side) * L
    off = rng.uniform(-W / 2, W / 2, n_g)
    gx = np.where(side == 0, u, np.where(side == 1, L, np.where(side == 2, L - u, 0.0)))
    gy = np.where(side == 0, 0.0, np.where(side == 1, u, np.where(side == 2, L, L - u)))
    nx = np.where((side == 0) | (side == 2), 0.0, 1.0)
    ny = 1.0 - nx
    pts.append(np.stack([gx + off * nx, gy + off * ny, np.zeros(n_g)], 1))
    # building facades: inner + outer walls along each side, 3-12 m tall
    n_w = n_points // 2
    t = rng.uniform(0, 4, n_w)
    side = np.floor(t).astype(int)
    u = (t - side) * L
    inner = rng.uniform(0, 1, n_w) < 0.5
    d = np.where(inner, -W / 2 - 1.0, W / 2 + 1.0)
    z = rng.uniform(0.0, rng.uniform(3, 12, n_w))
    wx = np.where(side == 0, u, np.where(side == 1, L, np.where(side == 2, L - u, 0.0)))
    wy = np.where(side == 0, 0.0, np.where(side == 1, u, np.where(side == 2, L, L - u)))
    nx = np.where((side == 0) | (side == 2), 0.0, 1.0)
    ny = 1.0 - nx
    pts.append(np.stack([wx + d * nx, wy + d * ny, z], 1))
    # poles
    n_p = n_points - n_g - n_w
    px = rng.uniform(-5, L + 5, n_p)
    py = rng.uniform(-5, L + 5, n_p)
    keep = (np.minimum(np.abs(px), np.abs(px - L)) < W) | (np.minimum(np.abs(py), np.abs(py - L)) < W)
    pz = rng.uniform(0, 6, n_p)
    pts.append(np.stack([px, py, pz], 1)[keep])
    world = np.concatenate(pts, 0).astype(np.float32)
    world += rng.normal(0, 0.01, world.shape).astype(np.float32)
    return world


def circuit_pose(s, L=120.0):
    """Pose on the rectangular circuit at arc length s: (pos (3,), yaw)."""
    P = 4 * L
    s = s % P
    side = int(s // L)
    u = s - side * L
    if side == 0:
        pos = np.array([u, 0.0, 0.0]); yaw = 0.0
    elif side == 1:
        pos = np.array([L, u, 0.0]); yaw = np.pi / 2
    elif side == 2:
        pos = np.array([L - u, L, 0.0]); yaw = np.pi
    else:
        pos = np.array([0.0, L - u, 0.0]); yaw = -np.pi / 2
    return pos + np.array([0.0, 0.0, 1.8]), yaw


def yaw_R(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def scan_from(world, pos, R, n_out, max_range, rng):
    rel = (world - pos) @ R
    r = np.linalg.norm(rel, axis=1)
    vis = rel[(r < max_range) & (r > 1.5)]
    if len(vis) == 0:
        return np.zeros((0, 3), np.float32)
    idx = rng.choice(len(vis), size=min(n_out, len(vis)), replace=False)
    return vis[idx].astype(np.float32)


def gen_kitti(args):
    out = args.out
    os.makedirs(os.path.join(out, "velodyne"), exist_ok=True)
    world = make_street_world(seed=args.seed)
    rng = np.random.default_rng(args.seed + 1)
    speed, dt = 8.0, 0.1   # m/s, 10 Hz
    poses = []
    for f in range(args.frames):
        pos, yaw = circuit_pose(f * speed * dt)
        R = yaw_R(yaw)
        pts = scan_from(world, pos, R, args.points, 60.0, rng)
        inten = rng.uniform(0, 1, (len(pts), 1)).astype(np.float32)
        np.concatenate([pts, inten], 1).tofile(os.path.join(out, "velodyne", f"{f:06d}.bin"))
        T = np.concatenate([R, pos[:, None]], 1)   # 3x4, lidar frame
        poses.append(T.reshape(-1))
    np.savetxt(os.path.join(out, "poses.txt"), np.stack(poses), fmt="%.9f")
    with open(os.path.join(out, "calib.txt"), "w") as f:
        f.write("Tr: 1 0 0 0 0 1 0 0 0 0 1 0\n")
    print(f"kitti sequence: {args.frames} frames -> {out}")


def gen_lio(args):
    """args: out, frames, points, seed, bag (as tools/make_dataset.py's)."""
    from pointcloud_slam_tpu_torch.io import pcd as pcdio
    from pointcloud_slam_tpu_torch.io import synthetic

    out = args.out
    os.makedirs(out, exist_ok=True)
    n_imu, frame_dt = 20, 0.1
    world = synthetic.make_room_cloud(120_000, seed=args.seed, size=30.0)
    traj = synthetic.make_imu_trajectory(args.frames, imu_per_frame=n_imu, frame_dt=frame_dt, seed=args.seed)
    rng = np.random.default_rng(args.seed + 1)
    # imu.csv: t, ax, ay, az, gx, gy, gz (sample i drives state i -> i+1)
    imu = np.concatenate([traj["t"][:, None], traj["acc"], traj["gyro"]], 1)
    np.savetxt(os.path.join(out, "imu.csv"), imu, delimiter=",", fmt="%.9f")
    scan_times = (np.arange(args.frames + 1) * frame_dt).astype(np.float64)
    np.savetxt(os.path.join(out, "scan_times.txt"), scan_times, fmt="%.9f")
    gt = []
    for f in range(args.frames):
        n_pts = args.points
        t_off = rng.uniform(0.0, frame_dt, n_pts).astype(np.float32)
        samp = np.clip((f * n_imu + (t_off / frame_dt * n_imu)).astype(int), 0, len(traj["pos"]) - 1)
        body_pts = np.zeros((n_pts, 3), np.float32)
        for s in np.unique(samp):
            m = samp == s
            pos, R = traj["pos"][s], traj["R"][s]
            rel = (world - pos) @ R
            r = np.linalg.norm(rel, axis=1)
            vis = rel[(r < 25.0) & (r > 0.3)]
            take = rng.choice(len(vis), size=int(m.sum()), replace=len(vis) < int(m.sum()))
            body_pts[m] = vis[take]
        ring = rng.integers(0, 16, n_pts).astype(np.float32)
        inten = rng.uniform(0, 255, n_pts).astype(np.float32)
        pcdio.write_pcd(os.path.join(out, f"frame_{f:06d}.pcd"), body_pts, intensity=inten,
                        extra_fields={"ring": ring, "time": t_off})
        i1 = (f + 1) * n_imu
        gt.append((scan_times[f + 1], traj["pos"][i1], traj["R"][i1]))
    with open(os.path.join(out, "gt_traj.txt"), "w") as fh:
        for t, p, R in gt:
            q = _to_quat(R)
            fh.write(f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")
    if args.bag:
        from pointcloud_slam_tpu_torch.io import rosbag

        with rosbag.BagWriter(os.path.join(out, "data.bag")) as bw:
            for i in range(len(traj["t"])):
                bw.write_imu("/imu/data", float(traj["t"][i]), traj["acc"][i], traj["gyro"][i])
            for f in range(args.frames):
                cloud = pcdio.read_pcd(os.path.join(out, f"frame_{f:06d}.pcd"))
                pts = np.stack([cloud["x"], cloud["y"], cloud["z"]], 1)
                bw.write_livox("/livox/lidar", float(scan_times[f]), pts,
                               (np.asarray(cloud["time"], np.float64) * 1e9).astype(np.uint32),
                               reflectivity=np.asarray(cloud["intensity"], np.float64).astype(np.uint8),
                               line=np.asarray(cloud["ring"], np.int32).astype(np.uint8))
        print(f"rosbag -> {os.path.join(out, 'data.bag')}")
    print(f"lio sequence: {args.frames} frames -> {out}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", nargs="?", default="lio", choices=["lio", "kitti"])
    p.add_argument("--out", required=True)
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--points", type=int, default=30_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bag", action="store_true", help="lio mode: also write the sequence as data.bag")
    args = p.parse_args(argv)
    (gen_kitti if args.mode == "kitti" else gen_lio)(args)


if __name__ == "__main__":
    main()
