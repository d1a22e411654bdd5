#!/usr/bin/env python
"""Localization soak on the PyTorch/CUDA port: the deployed prior-map mode
at lidar cadence (the counterpart of `tools/soak_localization.py`, same
flags and JSON line, with `--device` in place of `--platform`).

The reference runs new_localization at lidar rate
(src/jueying_slam/src/new_localization.cpp:77-2081); its real-time health is
the per-frame latency against the 100 ms scan period and the recovery after
a loss. This soak runs the port's feature-LOAM `localize_loam` frame by
frame at wall-clock `--hz` for `--seconds`, at bench.py config 8's shapes
(512 corner and 2,048 surface points a frame in the seed-3 feature world),
injects a pose loss mid-run (a +5, +5, +2 m teleport of the prediction),
relocalizes from the external pose (the GPS / initialPose role) and prints
one JSON line: p50/p90/p99/max latency, deadline misses, losses and
recoveries, and the error.

Each frame reads its pose, loss flag and fitness back once, because the
host decides on relocalization; `localize_loam` itself adds scan-to-map's
`eigh` reads. Maps, both code paths (match and relocalization) and the
library handles are warmed up before the paced loop.

    python tools/soak_localization_torch.py --seconds 60             # real time, on the GPU
    python tools/soak_localization_torch.py --seconds 2 --device cpu
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

N_CORNER, N_SURF = 512, 2048


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--hz", type=float, default=10.0)
    ap.add_argument("--loss_at_frac", type=float, default=0.5, help="inject a 5 m teleport at this fraction of the run")
    ap.add_argument("--device", default="cuda", help="torch device the localization runs on")
    return ap.parse_args(argv)


def scan_pose(k):
    """The soak's ground truth: a 3 m circle, 240 frames a lap."""
    ang = 2 * np.pi * (k % 240) / 240
    return np.array([3.0 * np.sin(ang), 3.0 * (1 - np.cos(ang)), 1.0], np.float32)


def main(argv=None):
    args = parse_args(argv)
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    from pointcloud_slam_tpu_torch import ops, register
    from pointcloud_slam_tpu_torch.geom import se3
    from pointcloud_slam_tpu_torch.io import synthetic
    from pointcloud_slam_tpu_torch.models.liosam import scan2map as s2m
    from pointcloud_slam_tpu_torch.models.localization import pipeline as loc
    from pointcloud_slam_tpu_torch.ops import small_eigh

    corners_w, surfs_w = synthetic.make_feature_world(seed=3)
    # degeneracy_eig=1.0 as bench.py config 8: the reference's threshold (100)
    # over-clamps at the prior map's density
    cfg = loc.LocalizationConfig(scan2map=s2m.Scan2MapConfig(solver=register.SolverConfig(max_iterations=6),
                                                             degeneracy_eig=1.0))
    maps = []
    for cloud, g in ((corners_w, cfg.scan2map.corner_grid), (surfs_w, cfg.scan2map.surf_grid)):
        pts = torch.from_numpy(np.ascontiguousarray(cloud.T.astype(np.float32))).to(device)
        maps.append(ops.insert(g, ops.create(g, device=device), pts,
                               torch.ones(pts.shape[1], dtype=torch.bool, device=device)))
    print("maps built", flush=True)
    eye = torch.eye(3, device=device)
    teleport = torch.tensor([5.0, 5.0, 2.0], device=device)

    def scan_at(t, k):
        c, cm = synthetic.take_scan(corners_w, np.eye(3, dtype=np.float32), t, N_CORNER, seed=k % 97)
        s, sm = synthetic.take_scan(surfs_w, np.eye(3, dtype=np.float32), t, N_SURF, seed=1000 + k % 97)
        return [torch.from_numpy(np.ascontiguousarray(a.T) if a.ndim == 2 else a).to(device) for a in (c, cm, s, sm)]

    def step(f, pose_R, pose_t, prev_t, lose):
        """Match from the constant-velocity prediction; one read back."""
        init_t = pose_t + (pose_t - prev_t)
        if lose:
            init_t = init_t + teleport
        res = loc.localize_loam(cfg, None, *maps, *f, se3.Pose(pose_R, init_t))
        flat = torch.cat([res.pose.R.reshape(-1), res.pose.t, res.lost.to(res.pose.t.dtype).reshape(1)]).cpu()
        return flat[:9].reshape(3, 3).to(device), flat[9:12].to(device), bool(flat[12]), flat[9:12].numpy()

    gt0 = scan_pose(0)
    f0 = scan_at(gt0, 0)
    pose_R, pose_t = eye, torch.from_numpy(gt0).to(device)
    prev_t = pose_t
    step(f0, pose_R, pose_t, prev_t, False)     # warm both paths outside the paced loop
    step(f0, pose_R, pose_t, prev_t, True)
    print("warm", flush=True)

    n_frames = int(args.seconds * args.hz)
    period = 1.0 / args.hz
    loss_frame = int(n_frames * args.loss_at_frac)
    lats, errs, misses, losses, recoveries = [], [], 0, 0, 0
    k6_start = small_eigh.eigh.launches + small_eigh.eigvalsh.launches
    t_start = time.perf_counter()
    for k in range(n_frames):
        deadline = t_start + k * period
        now = time.perf_counter()
        if now < deadline:
            time.sleep(deadline - now)
        gt = scan_pose(k)
        f = scan_at(gt, k)
        t0 = time.perf_counter()
        R_n, t_n, lost, t_host = step(f, pose_R, pose_t, prev_t, k == loss_frame)
        lats.append((time.perf_counter() - t0) * 1e3)
        if lost:
            losses += 1
            # relocalize from the external initial pose (localization.cpp relocalization)
            R2, t2, lost2, t2_host = step(f, eye, torch.from_numpy(gt).to(device), torch.from_numpy(gt).to(device),
                                          False)
            if not lost2:
                recoveries += 1
                prev_t, pose_R, pose_t, t_host = t2, R2, t2, t2_host
            else:
                prev_t = pose_t
        else:
            prev_t, pose_R, pose_t = pose_t, R_n, t_n
        if (time.perf_counter() - t0) > period:
            misses += 1
        errs.append(float(np.linalg.norm(t_host - gt)))

    lats = np.asarray(lats)
    print(json.dumps({
        "frames": n_frames,
        "device": str(device),
        "latency_p50_ms": round(float(np.percentile(lats, 50)), 1),
        "latency_p90_ms": round(float(np.percentile(lats, 90)), 1),
        "latency_p99_ms": round(float(np.percentile(lats, 99)), 1),
        "latency_max_ms": round(float(lats.max()), 1),
        "deadline_misses": misses,
        "losses": losses,
        "recoveries": recoveries,
        "err_p50_m": round(float(np.percentile(errs, 50)), 4),
        "err_max_m": round(float(np.max(errs)), 4),
        "err_final_m": round(errs[-1], 4),
        # kernel K6 (scan-to-map's eigendecompositions) on the card, over the
        # matches of the paced frames and their relocalizations
        "k6_launches": small_eigh.eigh.launches + small_eigh.eigvalsh.launches - k6_start,
        "matches": n_frames + losses,
    }))


if __name__ == "__main__":
    main()
