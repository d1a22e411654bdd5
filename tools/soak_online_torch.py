#!/usr/bin/env python
"""Online soak run on the PyTorch/CUDA port: the live-driver product shape
at sensor cadence (the counterpart of `tools/soak_online.py`, same flags and
JSON line, with `--device` in place of `--platform`).

Drives the whole online mapping stack: the native producer threads
(`native/src/live_driver.cpp`: IMU at 200 Hz + lidar sweeps at 10 Hz, paced
by the wall clock, the livox_ros_driver role) -> the native ingest frame
assembly (SyncPackages gate) -> the port's `lio_step` on the device, for a
sustained period. Per frame: the latency from the sweep's (scaled)
wall-clock completion to its pose on the host (the one read back a frame),
and the driver's queue depth at pop time. Prints one JSON line with
p50/p90/p99/max latency, queue-depth stats and trend, drops and ATE. A
healthy run has a bounded queue (no growth trend) and no drops.

Before the paced window the step is warmed up on the dataset's first frames
(a throwaway state): the native library, cuBLAS / cuSOLVER handles and
every kernel of the step are loaded before the clock starts.

    python tools/soak_online_torch.py --seconds 60                    # real time, on the GPU
    python tools/soak_online_torch.py --seconds 3 --time_scale 0.5 --n_points 2048 --device cpu
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

WARMUP_FRAMES = 4


def build_dataset(n_frames, imu_per_frame, frame_dt, n_pts, seed=0):
    """The JAX tool's dataset (same seeds, same numpy): a 30 m room of 60,000
    points and a tame trajectory that stays inside it."""
    from pointcloud_slam_tpu_torch.io import synthetic

    world = synthetic.make_room_cloud(60_000, seed=seed, size=30.0)
    traj = synthetic.make_imu_trajectory(n_frames + 1, imu_per_frame=imu_per_frame, frame_dt=frame_dt, seed=seed,
                                         acc_amp=0.15, yaw_rate_amp=0.15)
    rng = np.random.default_rng(seed)
    scans = []
    for f in range(n_frames):
        i0, i1 = f * imu_per_frame, (f + 1) * imu_per_frame
        pos, R = traj["pos"][i1], traj["R"][i1]
        rel = (world - pos) @ R
        r = np.linalg.norm(rel, axis=1)
        vis = rel[(r < 30.0) & (r > 0.3)]
        pts = vis[rng.choice(len(vis), size=min(n_pts, len(vis)), replace=False)].astype(np.float32)
        t0, t1 = traj["t"][i0], traj["t"][i1]
        t_pts = np.linspace(t0, t1, len(pts), endpoint=False) + (t1 - t0) / len(pts)
        scans.append((pts, t_pts, float(t0), float(t1), pos))
    return traj, scans


def soak_config():
    """The tuned LIO configuration (bench.py:177-182), as the JAX tool's."""
    from pointcloud_slam_tpu_torch import ops
    from pointcloud_slam_tpu_torch.models import lio

    return lio.LIOConfig(
        grid=ops.GridConfig(capacity=1 << 16, pts_per_voxel=3, resolution=0.4, nearby=7, probe=4, claim_rounds=2),
        scan_leaf=0.3, map_leaf=0.3, init_imu_frames=1, scan_budget=6144, insert_budget=2048,
        max_iterations=3, research_on_converge=False,
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--scan_hz", type=float, default=10.0)
    ap.add_argument("--imu_per_frame", type=int, default=20)  # 200 Hz at 10 Hz scans
    ap.add_argument("--n_points", type=int, default=4096)
    ap.add_argument("--time_scale", type=float, default=1.0, help="<1 replays faster than real time")
    ap.add_argument("--device", default="cuda", help="torch device the frame step runs on")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    from pointcloud_slam_tpu_torch import native
    from pointcloud_slam_tpu_torch.models import lio

    frame_dt = 1.0 / args.scan_hz
    n_frames = int(round(args.seconds * args.scan_hz))
    traj, scans = build_dataset(n_frames, args.imu_per_frame, frame_dt, args.n_points)
    cfg = soak_config()

    def to_frame(raw):
        return lio.LIOFrame(*(torch.from_numpy(raw[f]).to(device) for f in lio.LIOFrame._fields))

    def feed(shim, k):
        shim.load_imu(traj["t"][1: k + 1], traj["acc"][:k], traj["gyro"][:k])

    # warm-up outside the paced window: the dataset's first frames through the
    # ingest assembler and the step, on a state that is then thrown away
    warm = native.IngestShim(args.n_points, 64)
    k_warm = min(WARMUP_FRAMES, n_frames) * args.imu_per_frame
    warm.push_imu(traj["t"][1: k_warm + 1], traj["acc"][:k_warm], traj["gyro"][:k_warm])
    s = lio.create_state(cfg, device=device)
    for pts, t_pts, t0, t1, _ in scans[:WARMUP_FRAMES]:
        raw = warm.make_frame(pts, t_pts, t0, t1, blind=0.3, filter_num=1)
        if raw is not None:
            s, o = lio.lio_step(cfg, s, to_frame(raw))
            o.pos.cpu()
    del warm, s

    state = lio.create_state(cfg, device=device)
    shim = native.LiveDriverShim(args.n_points, 64, time_scale=args.time_scale, blind=0.3, filter_num=1)
    k = len(traj["t"]) - 1
    shim.load_imu(traj["t"][1: k + 1], traj["acc"][:k], traj["gyro"][:k])
    for pts, t_pts, t0, t1, _pos in scans:
        shim.load_scan(pts, t_pts, t0, t1)

    stamp0 = float(min(traj["t"][1], scans[0][2]))
    lat, depths, errs = [], [], []
    wall0 = time.perf_counter()
    shim.run()
    f_idx = 0
    while True:
        raw = shim.pop_frame(timeout_ms=2000)
        if raw is False:
            break
        if raw is None:
            continue
        depths.append(shim.queue_depth)
        state, out = lio.lio_step(cfg, state, to_frame(raw))
        pos = out.pos.cpu().numpy()  # the pose on the host: the frame's one read
        expected = wall0 + (scans[f_idx][3] - stamp0) * args.time_scale
        lat.append(time.perf_counter() - expected)
        errs.append(float(np.linalg.norm(pos - scans[f_idx][4])))
        f_idx += 1
    wall = time.perf_counter() - wall0

    lat_ms = np.asarray(lat) * 1e3
    q = np.asarray(depths, np.float64)
    n4 = max(len(q) // 4, 1)   # queue trend: mean depth of the last quarter vs the first
    print(json.dumps({
        "frames": f_idx, "dropped": n_frames - f_idx, "wall_s": round(wall, 2),
        "time_scale": args.time_scale, "scan_hz": args.scan_hz, "n_points": args.n_points,
        "device": str(device),
        "latency_ms": {"p50": round(float(np.percentile(lat_ms, 50)), 2),
                       "p90": round(float(np.percentile(lat_ms, 90)), 2),
                       "p99": round(float(np.percentile(lat_ms, 99)), 2),
                       "max": round(float(lat_ms.max()), 2)},
        "queue_depth": {"max": int(q.max()), "mean": round(float(q.mean()), 3),
                        "first_quarter_mean": round(float(q[:n4].mean()), 3),
                        "last_quarter_mean": round(float(q[-n4:].mean()), 3)},
        "ate_mean_m": round(float(np.mean(errs[5:])), 4) if f_idx > 5 else None,
        "ate_final_m": round(errs[-1], 4) if errs else None,
    }))


if __name__ == "__main__":
    main()
