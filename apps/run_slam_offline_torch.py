#!/usr/bin/env python
"""Offline LIO-SAM style SLAM replay on the PyTorch/CUDA port — the
counterpart of `apps/run_slam_offline.py` (reference mapOptmization node:
per-frame step, keyframe store growth, trajectory and pose-graph
artifacts), with `--device`.

Inputs: a ROS1 bag (`--bag_file`: PointCloud2 or Livox CustomMsg scans), a
directory of `frame_%06d.pcd` scans (`--data_dir`), or the synthetic loop
(`--synthetic N`: corner and surface scans of the feature-rich test world
taken along a circle). Recorded scans go through the range-image projection
and LOAM feature extraction first; every frame then goes through the port's
`slam_step` (scan-to-map + keyframes + dual loop closure + pose graph).
Outputs under --out_dir: traj_tum.txt, poses_kitti.txt, graph.g2o, with
`--save_artifacts` each keyframe's Scans/*.pcd and SCDs/*.scd, and with
`--debug loop_constraints,effect_points` those channels as npz files under
debug/ (the JAX app's array names: `pairs`, `endpoints_i`, `endpoints_j` on
a frame that closes a loop; `pts`, the newest keyframe's masked surface
points, on a keyframe). A channel reads from the device only when enabled.

    python apps/run_slam_offline_torch.py --synthetic 40                 # on the GPU
    python apps/run_slam_offline_torch.py --bag_file seq/data.bag
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
    p.add_argument("--data_dir", default="", help="directory of frame_%%06d.pcd scans")
    p.add_argument("--bag_file", default="", help="ROS1 bag to replay (PointCloud2/CustomMsg scans)")
    p.add_argument("--lidar_topic", default="", help="bag lidar topic (default: any lidar-typed topic)")
    p.add_argument("--out_dir", default="slam_out")
    p.add_argument("--n_corner", type=int, default=512)
    p.add_argument("--n_surf", type=int, default=2048)
    p.add_argument("--max_keyframes", type=int, default=512)
    p.add_argument("--baked_grids", type=int, default=1,
                   help="stencil-baked corner/surf local maps (one lookup per k-NN query inside "
                        "scan-to-map); 0 = the unbaked layout")
    p.add_argument("--save_artifacts", action="store_true", help="per-keyframe Scans/*.pcd and SCDs/*.scd")
    p.add_argument("--debug", default="", help="comma-separated debug channels to record "
                   "(loop_constraints, effect_points) — the reference's debug-topic role "
                   "(mapOptmization.cpp:1020-1068); written as npz under <out_dir>/debug")
    p.add_argument("--device", default="cuda", help="torch device the frame step runs on")
    return p.parse_args(argv)


def cloud_source(args):
    """Yield (k, cloud dict) scans from --bag_file (PointCloud2 of any schema,
    or Livox CustomMsg through the livox_repub conversion) or from a
    directory of frame_%06d.pcd files. Bag scans keep their stamp."""
    if args.bag_file:
        from pointcloud_slam_tpu_torch.io import converters, rosbag

        k = 0
        for topic, typ, t_rec, msg in rosbag.read_bag(args.bag_file):
            if typ == "sensor_msgs/Imu" or (args.lidar_topic and topic != args.lidar_topic):
                continue
            stamp = float(msg.get("stamp", t_rec))
            if typ.endswith("CustomMsg"):
                msg = converters.livox_custom_to_xyzirt(msg["x"], msg["y"], msg["z"], msg["reflectivity"],
                                                        msg["line"], msg["offset_time"])
            msg["stamp"] = stamp   # the RS loop gate's time input (the conversion drops it)
            yield k, msg
            k += 1
    else:
        from pointcloud_slam_tpu_torch.io import pcd

        names = sorted(f for f in os.listdir(args.data_dir) if f.startswith("frame_") and f.endswith(".pcd"))
        for k, name in enumerate(names):
            yield k, pcd.read_pcd(os.path.join(args.data_dir, name))


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


def record_debug(dbg, k, state, out):
    """Debug-topic analogues into `dbg` (a utils.log.DebugChannels) for
    frame k: on a frame that closes a loop, the loop-constraint pairs and
    their endpoints (visualizeLoopClosure's MarkerArray role); on a
    keyframe, the newest keyframe's masked surface points (the effect-points
    cloud role). The JAX app's channel and array names. Each channel reads
    back from the device only when it is enabled."""
    import torch

    if dbg.enabled("loop_constraints") and bool(out.loop_detected):
        nl = int(state.graph.n_loops)
        li, lj = state.graph.loop_i[:nl].long(), state.graph.loop_j[:nl].long()
        dbg.publish("loop_constraints", k, pairs=torch.stack([li, lj], 1).to(torch.int32),
                    endpoints_i=state.graph.t[li], endpoints_j=state.graph.t[lj])
    if dbg.enabled("effect_points") and bool(out.is_keyframe):
        kk = int(state.graph.n) - 1
        dbg.publish("effect_points", k, pts=state.kf_surf[kk][:, state.kf_surf_mask[kk]])


def main(argv=None):
    args = parse_args(argv)
    if not (args.synthetic > 0 or args.data_dir or args.bag_file):
        raise SystemExit("give --bag_file, --data_dir or --synthetic N")
    import torch

    from pointcloud_slam_tpu_torch.geom import so3
    from pointcloud_slam_tpu_torch.models.liosam import features, projection, slam
    from pointcloud_slam_tpu_torch.utils import checkpoint as ck
    from pointcloud_slam_tpu_torch.utils import log as plog

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    os.makedirs(args.out_dir, exist_ok=True)
    cfg = build_config(args)
    state = slam.create_state(cfg, device=device)
    pcfg = projection.ProjectionConfig()
    fcfg = features.FeatureConfig()
    dbg = plog.DebugChannels(os.path.join(args.out_dir, "debug"), enabled=[c for c in args.debug.split(",") if c])

    def soa(x):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32).T)).to(device)

    def frames():
        """(stamp for the step, stamp written out, corner, corner mask, surf, surf mask) on the device."""
        if args.synthetic > 0:
            from pointcloud_slam_tpu_torch.io.synthetic import take_scan

            for stamp, corners_w, surfs_w, R, t in synthetic_frames(args.synthetic):
                c, cm = take_scan(corners_w, R, t, cfg.n_corner, seed=int(stamp * 10))
                s, sm = take_scan(surfs_w, R, t, cfg.n_surf, seed=100 + int(stamp * 10))
                yield (stamp, stamp, soa(c), torch.from_numpy(cm).to(device), soa(s),
                       torch.from_numpy(sm).to(device))
            return
        cap = pcfg.n_scan * pcfg.horizon
        t0_stamp = None
        for k, cloud in cloud_source(args):
            pts = np.stack([cloud["x"], cloud["y"], cloud["z"]], axis=0).astype(np.float32)[:, :cap]
            pad = np.zeros((3, cap), np.float32)
            pad[:, :pts.shape[1]] = pts
            m = torch.from_numpy(np.arange(cap) < pts.shape[1]).to(device)
            cpts, cmask, spts, smask = features.front_end(pcfg, fcfg, torch.from_numpy(pad).to(device), m)
            # spread over every ring: the first n of a ring-ordered image are its lowest rings
            c, cm = features.spread_size(cpts, cmask, cfg.n_corner)
            s, sm = features.spread_size(spts, smask, cfg.n_surf)
            stamp = float(cloud.get("stamp", k * 0.1))
            if t0_stamp is None:
                t0_stamp = stamp
            # rebased in float64: ROS epoch stamps (~1.7e9 s) have a 128 s
            # float32 spacing, which would wreck the RS 30 s time gate
            yield stamp - t0_stamp, stamp, c, cm, s, sm

    times, poss, rots, looped = [], [], [], []
    t_start = time.perf_counter()
    for k, (step_stamp, stamp, c, cm, s, sm) in enumerate(frames()):
        state, out = slam.slam_step(cfg, state, c, cm, s, sm, time_sec=step_stamp)
        # unbounded trajectories: double the stores before they saturate
        if slam.needs_growth(cfg, state):
            old_kf = cfg.backend.max_keyframes
            cfg, state = slam.grow_state(cfg, state)
            print(f"keyframe store grown {old_kf} -> {cfg.backend.max_keyframes}")
        if args.save_artifacts and bool(out.is_keyframe):
            kk = int(state.graph.n) - 1
            ck.save_keyframe_artifacts(args.out_dir, kk, state.kf_surf[kk], state.kf_surf_mask[kk],
                                       state.sc_descs[kk], state.kf_corner[kk], state.kf_corner_mask[kk])
        record_debug(dbg, k, state, out)
        times.append(stamp)
        poss.append(out.pose.t)
        rots.append(out.pose.R)
        looped.append(out.loop_detected)
    dbg.close()
    if not times:
        raise SystemExit("no scans to replay")
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
