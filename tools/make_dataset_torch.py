#!/usr/bin/env python
"""Write a LIO replay dataset in the reference's input formats, with the
PyTorch port's own readers and writers (no jax): the `lio` mode of
`tools/make_dataset.py`, byte for byte the same files for the same seed.

The dataset directory holds `frame_%06d.pcd` (XYZ + intensity + ring +
per-point `time`; motion-distorted: each point is generated from the true
sensor pose at its own timestamp), `imu.csv` (t, ax, ay, az, gx, gy, gz),
`scan_times.txt` and `gt_traj.txt` (TUM). With `--bag` the same sequence is
also written as `data.bag`: Livox CustomMsg scans on `/livox/lidar` and
sensor_msgs/Imu on `/imu/data`, uncompressed.

    python tools/make_dataset_torch.py --out build/lio_seq --frames 20 --bag
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
    p.add_argument("--out", required=True)
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--points", type=int, default=30_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bag", action="store_true", help="also write the sequence as data.bag")
    gen_lio(p.parse_args(argv))


if __name__ == "__main__":
    main()
