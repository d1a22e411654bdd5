#!/usr/bin/env python
"""Offline LIO mapping replay on the PyTorch/CUDA port — the counterpart of
`apps/run_mapping_offline.py` (reference `run_mapping_offline.cc`), same
flags, plus `--device`.

This slice replays generated sequences (`--synthetic N`); the bag and
PCD-directory readers are not ported yet. Each frame goes through the
port's `lio_step`; the trajectory is written in TUM format.

    python apps/run_mapping_offline_torch.py --synthetic 40            # on the GPU
    python apps/run_mapping_offline_torch.py --synthetic 8 --device cpu
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config_file", default="", help="YAML with lio params (configs/lio/*.yaml)")
    p.add_argument("--synthetic", type=int, default=0, help="replay N synthetic frames")
    p.add_argument("--traj_log_file", default="traj.txt")
    p.add_argument("--n_points", type=int, default=8192)
    p.add_argument("--n_imu", type=int, default=64)
    p.add_argument("--device", default="cuda", help="torch device the frame step runs on")
    return p.parse_args(argv)


def build_config(args):
    """The per-lidar YAML mapping of apps/run_mapping_offline.py::build_config,
    onto the port's LIOConfig."""
    from pointcloud_slam_tpu_torch import ops
    from pointcloud_slam_tpu_torch.models import lio
    from pointcloud_slam_tpu_torch.utils import config as cfgio

    kw = {}
    grid_kw = {}
    if args.config_file:
        y = cfgio.load_yaml(args.config_file)
        m = y.get("mapping", y)
        # top-level scalars live beside the sections in the per-lidar YAMLs
        if y.get("filter_size_surf") is not None:
            kw["scan_leaf"] = float(y["filter_size_surf"])
        if y.get("filter_size_map") is not None:
            kw["map_leaf"] = float(y["filter_size_map"])
        if y.get("max_iteration") is not None:
            kw["max_iterations"] = int(y["max_iteration"])
        if y.get("esti_plane_threshold") is not None:
            kw["plane_threshold"] = float(y["esti_plane_threshold"])
        if y.get("ivox_grid_resolution") is not None:
            grid_kw["resolution"] = float(y["ivox_grid_resolution"])
        if y.get("ivox_nearby_type") is not None:
            grid_kw["nearby"] = {6: 7, 18: 19, 26: 27}.get(int(y["ivox_nearby_type"]), 7)
        if y.get("ivox_node_phc_order") is not None:
            raise SystemExit("ivox_node_phc_order: the PHC node mode is not ported yet")
        if "extrinsic_est_en" in m:
            kw["extrinsic_est"] = bool(m["extrinsic_est_en"])
        for key in ("acc_cov", "gyr_cov", "b_acc_cov", "b_gyr_cov"):
            if key in m:
                kw[key] = float(m[key])
        if "extrinsic_T" in m:
            kw["extrinsic_T"] = tuple(float(v) for v in m["extrinsic_T"])
        if "extrinsic_R" in m:
            kw["extrinsic_R"] = tuple(float(v) for v in m["extrinsic_R"])
    if grid_kw:
        kw["grid"] = ops.GridConfig(capacity=1 << 17, pts_per_voxel=8, **{"nearby": 7, **grid_kw})
    return lio.LIOConfig(**kw)


def main(argv=None):
    args = parse_args(argv)
    if args.synthetic <= 0:
        raise SystemExit("only --synthetic N replay is ported so far (bag and PCD-directory readers are not)")
    import torch

    from pointcloud_slam_tpu_torch.geom import so3
    from pointcloud_slam_tpu_torch.io.synthetic import simulate_lio_sequence
    from pointcloud_slam_tpu_torch.models import lio
    from pointcloud_slam_tpu_torch.utils import checkpoint as ck

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    cfg = build_config(args)
    _, traj, frames = simulate_lio_sequence(n_frames=args.synthetic, n_pts=min(args.n_points, 4000),
                                            device=device)
    state = lio.create_state(cfg, device=device)
    times, poss, rots = [], [], []
    t_start = time.perf_counter()
    for k, (frame, _, _) in enumerate(frames):
        state, out = lio.lio_step(cfg, state, frame)
        times.append((k + 1) * traj["frame_dt"])
        poss.append(out.pos)
        rots.append(out.rot)
    pos = torch.stack(poss).cpu().numpy()   # one read back for the whole run
    quats = so3.to_quat(torch.stack(rots)).cpu().numpy()
    wall = time.perf_counter() - t_start
    n = len(frames)
    print(f"frames: {n}  wall: {wall:.2f}s  mean FPS: {n / max(wall, 1e-9):.2f}  device: {device}")
    if args.traj_log_file:
        ck.save_trajectory_tum(args.traj_log_file, times, pos, quats)
        print(f"trajectory -> {args.traj_log_file}")


if __name__ == "__main__":
    main()
