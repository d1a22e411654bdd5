#!/usr/bin/env python
"""KITTI odometry runner on the PyTorch/CUDA port — the fast_gicp
`kitti.cpp` role; the counterpart of `apps/run_kitti.py`, same flags, with
`--device` in place of `--platform`.

Reference `src/pointcloud_match/fast_gicp/src/kitti.cpp:22-155`: load KITTI
velodyne `.bin` frames, voxel-downsample, register each frame to the
previous one with the last delta as the initial guess, accumulate the
trajectory, save KITTI-format poses.

Input: a directory with KITTI `velodyne/*.bin` (float32 x, y, z, intensity
records) or any directory of `*.bin` / `*.pcd` frames (`tools/make_dataset_torch.py
kitti` writes a synthetic street sequence). Output: poses in KITTI format
(row-major 3x4 per line) and the frame rate. `--algo vgicp` uses RBF source
covariances. The downsample, the selection of each frame's first N valid
points and the pose chain stay on the device; the poses are read back once.

    python apps/run_kitti_torch.py build/kitti_seq --algo vgicp          # on the GPU
    python apps/run_kitti_torch.py build/kitti_seq --algo icp --device cpu
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("data_dir", help="KITTI sequence dir (velodyne/*.bin) or dir of *.pcd")
    p.add_argument("--out", default="kitti_poses.txt")
    p.add_argument("--algo", default="vgicp", choices=["vgicp", "ndt", "icp"])
    p.add_argument("--leaf", type=float, default=0.25, help="downsample leaf (kitti.cpp uses 0.25)")
    p.add_argument("--n_points", type=int, default=30_000)
    p.add_argument("--max_frames", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device the registration runs on")
    return p.parse_args(argv)


def read_kitti_bin(path):
    pts = np.fromfile(path, np.float32).reshape(-1, 4)
    return pts[:, :3]


def frame_paths(data_dir):
    vd = os.path.join(data_dir, "velodyne")
    if os.path.isdir(vd):
        return [os.path.join(vd, f) for f in sorted(os.listdir(vd)) if f.endswith(".bin")]
    return [os.path.join(data_dir, f) for f in sorted(os.listdir(data_dir)) if f.endswith((".bin", ".pcd"))]


def load_frame(path):
    if path.endswith(".bin"):
        return read_kitti_bin(path)
    from pointcloud_slam_tpu_torch.io import pcd as pcdio

    return pcdio.read_pcd_xyz(path)


def fixed_cloud(raw, n, leaf, device):
    """Downsample on the device, then keep the first n valid points in index
    order (the JAX app's selection), padded to the static n: (3, n), (n,).
    The input is padded to a power of two at least n, as in the JAX app."""
    import torch

    from pointcloud_slam_tpu_torch import ops

    P = len(raw)
    cap = max(n, 1 << int(np.ceil(np.log2(max(P, 1)))))
    buf = np.zeros((3, cap), np.float32)
    buf[:, :P] = raw.T
    pts = torch.from_numpy(buf).to(device)
    mask = torch.arange(cap, device=device) < P
    pts_d, mask_d = ops.voxel_downsample(pts, mask, leaf)
    out, m = ops.compact(pts_d, mask_d, n)
    return torch.where(m[None, :], out, 0.0), m


def main(argv=None):
    args = parse_args(argv)
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    from pointcloud_slam_tpu_torch import ops, register
    from pointcloud_slam_tpu_torch.geom import se3
    from pointcloud_slam_tpu_torch.utils import checkpoint as ck

    paths = frame_paths(args.data_dir)
    if args.max_frames:
        paths = paths[: args.max_frames]
    if not paths:
        raise SystemExit(f"no frames under {args.data_dir}")
    print(f"{len(paths)} frames, algo={args.algo}, device={device}")

    # frame-to-model: each frame against the previous (downsampled) one with
    # the last delta as the initial guess (kitti.cpp's strategy); the JAX
    # app's configurations
    vcfg = register.VGICPConfig(resolution=1.0)
    ncfg = register.NDTConfig(resolution=2.0)
    icfg = register.ICPConfig(max_corr_dist=3.0)
    grid_pts = ops.GridConfig(capacity=1 << 16, pts_per_voxel=8, resolution=1.0, nearby=19)

    delta = se3.identity(device=device)
    poses_R, poses_t = [torch.eye(3, device=device)], [torch.zeros(3, device=device)]
    prev = None
    t0 = time.perf_counter()
    for k, path in enumerate(paths):
        cur, cur_m = fixed_cloud(load_frame(path), args.n_points, args.leaf, device)
        if prev is not None:
            tgt, tgt_m = prev
            if args.algo == "vgicp":
                gcfg, gmap = register.vgicp.build_target(vcfg, tgt, tgt_m, capacity=1 << 15)
                cov = register.source_covariances_rbf(cur, cur_m, resolution=1.0, kernel_width=0.5)
                res = register.vgicp.align(gcfg, gmap, cur, cov, cur_m, delta, cfg=vcfg)
            elif args.algo == "ndt":
                gcfg, gmap = register.ndt.build_target(ncfg, tgt, tgt_m, capacity=1 << 15)
                res = register.ndt.align(gcfg, gmap, cur, cur_m, delta, cfg=ncfg)
            else:
                _, pmap = register.build_target_map(tgt, tgt_m, grid_cfg=grid_pts)
                res = register.point_to_plane_icp(grid_pts, pmap, cur, cur_m, delta, cfg=icfg)
            delta = res.pose
            poses_t.append(poses_R[-1] @ res.pose.t + poses_t[-1])
            poses_R.append(poses_R[-1] @ res.pose.R)
        prev = (cur, cur_m)
        if (k + 1) % 50 == 0:
            el = time.perf_counter() - t0
            print(f"  frame {k + 1}/{len(paths)}  FPS {k / max(el, 1e-9):.2f}")
    Rs, ts = torch.stack(poses_R).cpu().numpy(), torch.stack(poses_t).cpu().numpy()   # the one read back
    wall = time.perf_counter() - t0
    print(f"done: {len(paths)} frames, {len(paths) / max(wall, 1e-9):.2f} FPS")
    ck.save_poses_kitti(args.out, Rs, ts)
    print(f"KITTI poses -> {args.out}")


if __name__ == "__main__":
    main()
