#!/usr/bin/env python
"""Offline LIO mapping replay on the PyTorch/CUDA port — the counterpart of
`apps/run_mapping_offline.py` (reference `run_mapping_offline.cc`), same
flags, plus `--device`.

Inputs: a recorded ROS1 bag (`--bag_file`: Livox CustomMsg or PointCloud2
scans and sensor_msgs/Imu, read by the native C++ reader or the pure-Python
one), a dataset directory (`--data_dir`: `frame_%06d.pcd` with per-point
times, `imu.csv`, `scan_times.txt`, as `tools/make_dataset_torch.py lio`
writes it), or `--synthetic N`. Each frame goes through the port's
`lio_step`; the trajectory is written in TUM format and, with `--map_file`,
the final map as a PCD; per-frame stage times (the self time of each of
`lio_step`'s spans, a row a frame) go to `--time_log_file` (the CSV
`apps/plot_timings.py` reads), and `--auto_grid` sizes the voxel
map to the first scan's point spacing.

    python apps/run_mapping_offline_torch.py --synthetic 40            # on the GPU
    python apps/run_mapping_offline_torch.py --bag_file seq/data.bag
    python apps/run_mapping_offline_torch.py --data_dir seq --device cpu
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config_file", default="", help="YAML with lio params (configs/lio/*.yaml)")
    p.add_argument("--bag_file", default="", help="ROS1 bag to replay (CustomMsg/PointCloud2 + Imu)")
    p.add_argument("--lidar_topic", default="", help="bag lidar topic (default: any lidar-typed topic)")
    p.add_argument("--imu_topic", default="", help="bag IMU topic (default: any sensor_msgs/Imu)")
    p.add_argument("--bag_reader", default="auto", choices=("auto", "native", "python"),
                   help="bag parser: native C++ (native/src/bagreader.cpp), pure Python (io.rosbag), "
                        "or auto (native, falling back to Python for bz2 chunks)")
    p.add_argument("--data_dir", default="", help="dataset directory (PCD frames + imu.csv + scan_times.txt)")
    p.add_argument("--synthetic", type=int, default=0, help="replay N synthetic frames")
    p.add_argument("--traj_log_file", default="traj.txt")
    p.add_argument("--time_log_file", default="time.csv",
                   help="per-stage timer CSV (Timer.dump_into_file); an empty string writes none")
    p.add_argument("--map_file", default="", help="save the final map as a PCD here")
    p.add_argument("--n_points", type=int, default=8192)
    p.add_argument("--n_imu", type=int, default=64)
    p.add_argument("--auto_grid", action="store_true",
                   help="size the voxel map (resolution + stencil) to the first scan's measured point "
                        "spacing (ops/tuning.py) instead of the config defaults")
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
            # PHC node mode (IVOX_NODE_TYPE_PHC, ivox3d_node.hpp): sub-voxel
            # Hilbert centroid merge on insert
            kw["phc_order"] = int(y["ivox_node_phc_order"])
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


def _imu_window(imu, t0, t1):
    """imu rows (t, ax..az, gx..gz): the measurements whose interval lies in
    [t0, t1), stamped at their interval end (the ImuProcess convention:
    sample i drives the state from t_i to t_{i+1})."""
    t_all = imu[:, 0]
    dt_all = np.diff(t_all, append=t_all[-1] + (t_all[-1] - t_all[-2] if len(t_all) > 1 else 0.005))
    sel = (t_all >= t0) & (t_all < t1)
    return imu[sel], (t_all[sel] - t0) + dt_all[sel]


def frames_from_bag(args, device="cuda"):
    """Replay a recorded ROS1 bag (run_mapping_offline.cc:46-82 iterates
    rosbag records and dispatches CustomMsg / PointCloud2 / Imu callbacks).
    Livox CustomMsg scans go through the livox_repub conversion; PointCloud2
    schemas keep their vendor fields so per-point times resolve by the usual
    priority chain. Yields (LIOFrame on `device`, end stamp).

    --bag_reader: 'native' = the C++ reader, 'python' = io.rosbag, 'auto'
    prefers native and falls back to Python for bags it cannot take (bz2)."""
    from pointcloud_slam_tpu_torch.io import converters, feed

    imu_rows, scans = [], []
    reader_used = args.bag_reader
    if reader_used in ("auto", "native"):
        from pointcloud_slam_tpu_torch import native

        try:
            with native.NativeBagReader(args.bag_file, args.lidar_topic, args.imu_topic) as nb:
                for kind, payload in nb:
                    if kind == "imu":
                        t, acc, gyro = payload
                        imu_rows.append([t, *acc, *gyro])
                    else:
                        stamp, xyz, t_abs, _intensity, ring = payload
                        # time source 0 = no per-point channel: the Python
                        # priority chain below tries ring/yaw synthesis
                        scans.append((stamp, xyz, (t_abs - stamp).astype(np.float32), ring, nb.cloud_time_source))
        except ValueError as e:
            if reader_used == "native":
                raise SystemExit(f"native bag reader: {e}")
            reader_used = "python"  # e.g. bz2 chunks
        else:
            reader_used = "native"
    if reader_used != "native":
        from pointcloud_slam_tpu_torch.io import rosbag

        for topic, typ, _t, msg in rosbag.read_bag(args.bag_file):
            if typ == "sensor_msgs/Imu":
                if not args.imu_topic or topic == args.imu_topic:
                    imu_rows.append([msg["stamp"], *msg["acc"], *msg["gyro"]])
            elif not args.lidar_topic or topic == args.lidar_topic:
                if typ.endswith("CustomMsg"):
                    cloud = converters.livox_custom_to_xyzirt(msg["x"], msg["y"], msg["z"], msg["reflectivity"],
                                                              msg["line"], msg["offset_time"])
                else:
                    cloud = msg
                pts = np.stack([cloud["x"], cloud["y"], cloud["z"]], axis=1).astype(np.float32)
                scans.append((msg["stamp"], pts, cloud, None, None))
    if not scans:
        raise SystemExit(f"{args.bag_file}: no lidar scans found"
                         + (f" on topic {args.lidar_topic}" if args.lidar_topic else ""))
    if not imu_rows:
        raise SystemExit(f"{args.bag_file}: no IMU messages found"
                         + (f" on topic {args.imu_topic}" if args.imu_topic else "")
                         + " — the LIO loop needs sensor_msgs/Imu covering every scan")
    imu = np.asarray(imu_rows, np.float64).reshape(-1, 7)
    scans.sort(key=lambda s: s[0])
    for k, (t0, pts, third, ring, tsrc) in enumerate(scans):
        t1 = scans[k + 1][0] if k + 1 < len(scans) else t0 + 0.1
        chunk, t_end = _imu_window(imu, t0, t1)
        if tsrc is None:          # python reader: third is the cloud dict
            pts = np.ascontiguousarray(pts, np.float32)
            t_offs = converters.point_times_from_cloud(third, scan_duration=float(t1 - t0))
        elif tsrc == 0:
            # the native reader found no per-point time channel (its ramp
            # assumes 0.1 s): redo the Python priority chain with the actual
            # inter-scan gap, so both readers give the same frames
            cloud = {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2]}
            if ring is not None and np.any(ring):
                cloud["ring"] = ring
            t_offs = converters.point_times_from_cloud(cloud, scan_duration=float(t1 - t0))
        else:
            t_offs = third
        yield feed.make_frame(pts, t_offs, chunk[:, 1:4].astype(np.float32), chunk[:, 4:7].astype(np.float32),
                              t_end.astype(np.float32), args.n_points, args.n_imu, prev_imu_t=0.0,
                              device=device), t1


def frames_from_dir(args, device="cuda"):
    """Replay frame_%06d.pcd + imu.csv + scan_times.txt. Per-point time
    offsets come from the PCD's own fields when present
    (converters.point_times_from_cloud), else a linear ramp over the scan."""
    from pointcloud_slam_tpu_torch.io import converters, feed, pcd

    imu = np.loadtxt(os.path.join(args.data_dir, "imu.csv"), delimiter=",")
    frame_files = sorted(f for f in os.listdir(args.data_dir) if f.startswith("frame_") and f.endswith(".pcd"))
    scan_times = np.loadtxt(os.path.join(args.data_dir, "scan_times.txt"))
    for k, name in enumerate(frame_files):
        cloud = pcd.read_pcd(os.path.join(args.data_dir, name))
        pts = np.stack([cloud["x"], cloud["y"], cloud["z"]], axis=1).astype(np.float32)
        t0 = scan_times[k]
        t1 = scan_times[k + 1] if k + 1 < len(scan_times) else t0 + 0.1
        chunk, t_end = _imu_window(imu, t0, t1)
        t_offs = converters.point_times_from_cloud(cloud, scan_duration=float(t1 - t0))
        yield feed.make_frame(pts, t_offs, chunk[:, 1:4].astype(np.float32), chunk[:, 4:7].astype(np.float32),
                              t_end.astype(np.float32), args.n_points, args.n_imu, prev_imu_t=0.0,
                              device=device), t1


def frames_synthetic(args, device="cuda"):
    from pointcloud_slam_tpu_torch.io.synthetic import simulate_lio_sequence

    _, traj, frames = simulate_lio_sequence(n_frames=args.synthetic, n_pts=min(args.n_points, 4000), device=device)
    for k, (frame, _, _) in enumerate(frames):
        yield frame, (k + 1) * traj["frame_dt"]


def map_points(grid):
    """(N, 3) valid points of a voxel map: block row k of a slot is valid
    iff k < npts[slot]."""
    valid = np.arange(grid.pts.shape[1])[:, None] < grid.npts.cpu().numpy()[None, :]
    return grid.pts.cpu().numpy().reshape(3, -1).T[valid.reshape(-1)]


def main(argv=None):
    args = parse_args(argv)
    import torch

    from pointcloud_slam_tpu_torch.geom import so3
    from pointcloud_slam_tpu_torch.models import lio
    from pointcloud_slam_tpu_torch.utils import checkpoint as ck
    from pointcloud_slam_tpu_torch.utils.timer import Timer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    cfg = build_config(args)
    if args.bag_file:
        src = frames_from_bag(args, device)
    elif args.data_dir:
        src = frames_from_dir(args, device)
    elif args.synthetic > 0:
        src = frames_synthetic(args, device)
    else:
        raise SystemExit("give --bag_file, --data_dir or --synthetic N")
    if args.auto_grid:
        # measure the first scan's point spacing and size the map grid to it
        # (ops/tuning.py): the robust fallback when no per-lidar YAML matches
        # the sensor. The probed frame is chained back, so the input is read once.
        import dataclasses
        import itertools

        from pointcloud_slam_tpu_torch.ops import tuning

        first = next(src)
        src = itertools.chain([first], src)
        g = tuning.suggest_grid(first[0].pts, first[0].pt_mask, capacity=cfg.grid.capacity,
                                pts_per_voxel=cfg.grid.pts_per_voxel)
        print(f"auto_grid: resolution {g.resolution} m, stencil {g.nearby}")
        cfg = dataclasses.replace(cfg, grid=g)
    state = lio.create_state(cfg, device=device)
    times, poss, rots = [], [], []
    Timer.reset()
    # lio_step's spans on the host clock, one frame of self times a step; no wait a frame
    Timer.enable(bool(args.time_log_file))
    t_start = time.perf_counter()
    try:
        for frame, stamp in src:
            state, out = lio.lio_step(cfg, state, frame)
            times.append(stamp)
            poss.append(out.pos)
            rots.append(out.rot)
    finally:
        Timer.enable(False)
    pos = torch.stack(poss).cpu().numpy()   # one read back for the whole run
    quats = so3.to_quat(torch.stack(rots)).cpu().numpy()
    wall = time.perf_counter() - t_start
    n = len(times)
    print(f"frames: {n}  wall: {wall:.2f}s  mean FPS: {n / max(wall, 1e-9):.2f}  device: {device}")
    if args.time_log_file:
        Timer.print_all()
        Timer.dump_into_file(args.time_log_file)
        print(f"stage times -> {args.time_log_file}")
    if args.traj_log_file:
        ck.save_trajectory_tum(args.traj_log_file, times, pos, quats)
        print(f"trajectory -> {args.traj_log_file}")
    if args.map_file:
        from pointcloud_slam_tpu_torch.io import pcd

        pts = map_points(state.grid)
        pcd.write_pcd(args.map_file, pts)
        print(f"map ({len(pts)} pts) -> {args.map_file}")


if __name__ == "__main__":
    main()
