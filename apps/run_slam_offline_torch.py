#!/usr/bin/env python
"""Offline LIO-SAM style SLAM replay on the PyTorch/CUDA port — the
counterpart of `apps/run_slam_offline.py` (reference mapOptmization node:
per-frame step, keyframe store growth, trajectory and pose-graph
artifacts), with `--device`.

This app replays the synthetic loop (`--synthetic N`): corner and surface
scans of the feature-rich test world taken along a circle, each frame
through the port's `slam_step` (scan-to-map + keyframes + dual loop
closure + pose graph). The PCD-directory and bag replays (`--data_dir`,
`--bag_file`) need the native loader and the I/O readers, which are not
ported yet. Outputs under --out_dir: traj_tum.txt, poses_kitti.txt,
graph.g2o.

    python apps/run_slam_offline_torch.py --synthetic 40                 # on the GPU
    python apps/run_slam_offline_torch.py --synthetic 12 --device cpu
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--synthetic", type=int, default=0, help="replay N frames of the synthetic loop")
    p.add_argument("--data_dir", default="", help="frame_%%06d.pcd directory: not ported yet (needs the native "
                                                  "loader and the I/O slice)")
    p.add_argument("--bag_file", default="", help="ROS1 bag: not ported yet (needs the native loader and the "
                                                  "I/O slice)")
    p.add_argument("--out_dir", default="slam_out")
    p.add_argument("--n_corner", type=int, default=512)
    p.add_argument("--n_surf", type=int, default=2048)
    p.add_argument("--max_keyframes", type=int, default=512)
    p.add_argument("--baked_grids", type=int, default=1,
                   help="stencil-baked corner/surf local maps (one lookup per k-NN query inside "
                        "scan-to-map); 0 = the unbaked layout")
    p.add_argument("--device", default="cuda", help="torch device the frame step runs on")
    return p.parse_args(argv)


def synthetic_frames(n):
    """The SLAM test world (a feature-rich yard) and a loop trajectory, as
    apps/run_slam_offline.py replays it: (stamp, corners, surfs, R, t)."""
    from pointcloud_slam_tpu_torch.io.synthetic import make_feature_world

    corners_w, surfs_w = make_feature_world(seed=1)
    for k in range(n):
        ang = 2 * np.pi * k / max(n - 1, 1)
        t = np.array([3.0 * np.sin(ang), 3.0 * (1 - np.cos(ang)), 1.0], np.float32)
        yield k * 0.1, corners_w, surfs_w, np.eye(3, dtype=np.float32), t


def build_config(args):
    from pointcloud_slam_tpu_torch.models.liosam import backend as bk
    from pointcloud_slam_tpu_torch.models.liosam import scan2map as s2m
    from pointcloud_slam_tpu_torch.models.liosam import slam

    s2m_cfg = s2m.Scan2MapConfig()
    if args.baked_grids:
        s2m_cfg = dataclasses.replace(s2m_cfg, corner_grid=s2m.baked_grid(s2m_cfg.corner_grid),
                                      surf_grid=s2m.baked_grid(s2m_cfg.surf_grid))
    return slam.SLAMConfig(backend=bk.BackendConfig(max_keyframes=args.max_keyframes), n_corner=args.n_corner,
                           n_surf=args.n_surf, scan2map=s2m_cfg)


def main(argv=None):
    args = parse_args(argv)
    if args.data_dir or args.bag_file:
        raise SystemExit("--data_dir / --bag_file: not ported yet (they need the native loader and the I/O slice); "
                         "use --synthetic N")
    if args.synthetic <= 0:
        raise SystemExit("give --synthetic N (the only replay ported so far)")
    import torch

    from pointcloud_slam_tpu_torch.geom import so3
    from pointcloud_slam_tpu_torch.io.synthetic import take_scan
    from pointcloud_slam_tpu_torch.models.liosam import slam
    from pointcloud_slam_tpu_torch.utils import checkpoint as ck

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    os.makedirs(args.out_dir, exist_ok=True)
    cfg = build_config(args)
    state = slam.create_state(cfg, device=device)

    def soa(x):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32).T)).to(device)

    times, poss, rots, looped = [], [], [], []
    t_start = time.perf_counter()
    for stamp, corners_w, surfs_w, R, t in synthetic_frames(args.synthetic):
        c, cm = take_scan(corners_w, R, t, cfg.n_corner, seed=int(stamp * 10))
        s, sm = take_scan(surfs_w, R, t, cfg.n_surf, seed=100 + int(stamp * 10))
        state, out = slam.slam_step(cfg, state, soa(c), torch.from_numpy(cm).to(device), soa(s),
                                    torch.from_numpy(sm).to(device), time_sec=stamp)
        # unbounded trajectories: double the stores before they saturate
        if slam.needs_growth(cfg, state):
            old_kf = cfg.backend.max_keyframes
            cfg, state = slam.grow_state(cfg, state)
            print(f"keyframe store grown {old_kf} -> {cfg.backend.max_keyframes}")
        times.append(stamp)
        poss.append(out.pose.t)
        rots.append(out.pose.R)
        looped.append(out.loop_detected)
    pos = torch.stack(poss).cpu().numpy()   # one read back for the whole run
    quats = so3.to_quat(torch.stack(rots)).cpu().numpy()
    n_loops = int(torch.stack(looped).sum())
    wall = time.perf_counter() - t_start
    nkf = int(state.graph.n)
    n = len(times)
    print(f"frames: {n}  keyframes: {nkf}  loops: {n_loops}  wall: {wall:.1f}s  FPS: {n / max(wall, 1e-9):.2f}  "
          f"device: {device}")
    ck.save_trajectory_tum(os.path.join(args.out_dir, "traj_tum.txt"), times, pos, quats)
    ck.save_poses_kitti(os.path.join(args.out_dir, "poses_kitti.txt"), state.graph.R[:nkf].cpu().numpy(),
                        state.graph.t[:nkf].cpu().numpy())
    ck.save_pose_graph_g2o(os.path.join(args.out_dir, "graph.g2o"), state.graph)
    print(f"outputs -> {args.out_dir}/ (traj_tum.txt, poses_kitti.txt, graph.g2o)")


if __name__ == "__main__":
    main()
