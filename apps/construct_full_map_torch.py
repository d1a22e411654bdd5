#!/usr/bin/env python
"""Offline full-map reconstruction from saved keyframes + poses on the
PyTorch/CUDA port — the counterpart of `apps/construct_full_map.py`, same
flags and outputs, plus `--device`.

Behavioral parity target, as in the JAX app:
  - `scripts/construct_full_map.sh:1-10` (keyframes + poses -> full map PCD),
  - `src/tool/occupancy_mapping` `OccupancyServerFromFile` (:384-622):
    keyframe PCDs + pose file -> occupancy grid map(s) as PGM/YAML,
  - the octomap_saver `.bt` octree and the corner/surf feature tile maps
    (with `*_arealist.csv`) that `apps/run_localization_torch.py
    --feature_map_dir` loads.

Inputs: a directory of `key_%06d.pcd`, or the `Scans/%06d.pcd` (+
`%06d_corner.pcd`) that `apps/run_slam_offline_torch.py --save_artifacts`
writes, and `poses_kitti.txt` (row-major 3x4 per line). Every keyframe goes
to the device once; the downsample runs in chunks of 2^18 points and the
ray casting in chunks of 2^15 points a keyframe, so device memory stays
bounded whatever the map's size.

    python apps/construct_full_map_torch.py slam_out --feature_maps maps --occupancy maps/grid --bt maps/map.bt
    python apps/construct_full_map_torch.py slam_out --device cpu
"""

import argparse
import os
import sys
from typing import List, NamedTuple

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

CH = 1 << 18   # downsample chunk (points)
NP = 1 << 15   # ray-casting chunk (points of one keyframe)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("keyframe_dir")
    p.add_argument("--poses", default="poses_kitti.txt")
    p.add_argument("--out", default="full_map.pcd")
    p.add_argument("--leaf", type=float, default=0.2)
    p.add_argument("--occupancy", default="", help="also save occupancy map at this path prefix")
    p.add_argument("--occ_size", type=int, default=1024)
    p.add_argument("--occ_res", type=float, default=0.1)
    p.add_argument("--floor_labels", default="", help="file with one integer floor label per "
                   "keyframe: one occupancy map per floor (OccupancyServerFromFile :445-595; "
                   "label 0 saves without a suffix, negative labels are skipped)")
    p.add_argument("--bt", default="", help="also save a 3-D octomap .bt octree at this path "
                   "(octomap_server/octomap_saver artifact: per-keyframe beam carving from the "
                   "keyframe origin, OctomapServer::insertCloudCallback role)")
    p.add_argument("--bt_res", type=float, default=0.2)
    p.add_argument("--feature_maps", default="", help="also build corner/surf feature tile maps "
                   "at this directory (the globalCornerMap/globalSurfMap products that "
                   "new_localization.cpp:309-321 loads): requires Scans/%%06d.pcd + "
                   "%%06d_corner.pcd artifacts (run_slam_offline_torch --save_artifacts)")
    p.add_argument("--tile", type=float, default=50.0, help="feature-map tile edge [m]")
    p.add_argument("--device", default="cuda", help="torch device the map products are built on")
    return p.parse_args(argv)


class Keyframes(NamedTuple):
    """Keyframe clouds in the world frame: `world` holds them all, keyframe k
    in columns `offsets[k]:offsets[k + 1]`."""

    names: List[str]        # keyframe files, relative to the keyframe directory
    poses: np.ndarray       # (K, 3, 4) float64
    world: "torch.Tensor"   # (3, N) float32 on the device
    offsets: np.ndarray     # (K + 1,) int64

    def cloud(self, k):
        """Keyframe k's world-frame points (3, n_k), a view of `world`."""
        return self.world[:, int(self.offsets[k]) : int(self.offsets[k + 1])]

    def head(self, n):
        """The first n keyframes."""
        return Keyframes(self.names[:n], self.poses[:n], self.world[:, : int(self.offsets[n])], self.offsets[: n + 1])


def load_keyframes(keyframe_dir, poses_name, device) -> Keyframes:
    """Read the keyframes and their poses; one host-to-device copy of all
    world-frame points (transformed in float64 on the host, as the JAX app does)."""
    import torch

    from pointcloud_slam_tpu_torch.io import pcd as pcdio

    poses = np.loadtxt(os.path.join(keyframe_dir, poses_name)).reshape(-1, 3, 4)
    frames = sorted(f for f in os.listdir(keyframe_dir) if f.startswith("key_") and f.endswith(".pcd"))
    if not frames and os.path.isdir(os.path.join(keyframe_dir, "Scans")):
        # run_slam_offline_torch --save_artifacts layout: Scans/%06d.pcd
        # keyframe surf clouds (the saveKeyFramesAndFactor product, :1868-1880)
        frames = sorted(os.path.join("Scans", f) for f in os.listdir(os.path.join(keyframe_dir, "Scans"))
                        if f.endswith(".pcd") and "_corner" not in f)
    if len(frames) > len(poses):
        raise SystemExit(f"{len(frames)} keyframes but {len(poses)} poses")
    clouds = []
    for k, name in enumerate(frames):
        pts = pcdio.read_pcd_xyz(os.path.join(keyframe_dir, name))
        R, t = poses[k, :, :3], poses[k, :, 3]
        clouds.append((pts @ R.T + t).astype(np.float32))
    world = np.concatenate(clouds) if clouds else np.zeros((0, 3), np.float32)
    offsets = np.concatenate([[0], np.cumsum([len(c) for c in clouds])]).astype(np.int64)
    return Keyframes(frames, poses[: len(frames)], torch.from_numpy(np.ascontiguousarray(world.T)).to(device),
                     offsets)


def full_map(kf: Keyframes, leaf: float) -> np.ndarray:
    """Voxel-downsampled full map (M, 3): chunks of CH points, then a second
    pass across chunk bounds when the result fits one chunk (the JAX app's
    rule). One read of the kept count and one of the points."""
    import torch

    from pointcloud_slam_tpu_torch import ops

    def downsample(pts):
        outs, masks = [], []
        for i in range(0, pts.shape[1], CH):
            chunk = pts[:, i : i + CH]
            out, om = ops.voxel_downsample(chunk, torch.ones(chunk.shape[1], dtype=torch.bool, device=chunk.device),
                                           leaf)
            outs.append(out)
            masks.append(om)
        return torch.cat(outs, dim=1)[:, torch.cat(masks)], len(outs)

    full, n_chunks = downsample(kf.world)
    if n_chunks > 1 and full.shape[1] <= CH:
        full, _ = downsample(full)
    return full.T.cpu().numpy()


def feature_maps(keyframe_dir, kf: Keyframes, out_dir, tile: float):
    """Corner/surf feature tile maps from the per-keyframe feature artifacts:
    each family in the world frame, split into `tile` m AABB tiles, indexed
    by `<family>_arealist.csv` — the products new_localization consumes
    (read_arealist + create_pcd, new_localization.cpp:309-321,
    dynamic_map.h:16-187). Host numpy, as in the JAX app. Returns
    {family: (points, tiles)} of the families written."""
    from pointcloud_slam_tpu_torch.io import pcd as pcdio

    scans_dir = os.path.join(keyframe_dir, "Scans")
    os.makedirs(out_dir, exist_ok=True)
    written = {}
    for fam, pat in (("surf", "%06d.pcd"), ("corner", "%06d_corner.pcd")):
        fam_clouds = []
        for k in range(len(kf.names)):
            path = os.path.join(scans_dir, pat % k)
            if not os.path.exists(path):
                continue
            pts = pcdio.read_pcd_xyz(path)
            if len(pts) == 0:
                continue
            R, t = kf.poses[k, :, :3], kf.poses[k, :, 3]
            fam_clouds.append(pts @ R.T + t)
        if not fam_clouds:
            print(f"feature maps: no {fam} artifacts found, skipped")
            continue
        w = np.concatenate(fam_clouds).astype(np.float32)
        tx = np.floor(w[:, 0] / tile).astype(np.int64)
        ty = np.floor(w[:, 1] / tile).astype(np.int64)
        rows = []
        for key in sorted(set(zip(tx.tolist(), ty.tolist()))):
            m = (tx == key[0]) & (ty == key[1])
            name = f"{fam}_{key[0]}_{key[1]}.pcd"
            pcdio.write_pcd(os.path.join(out_dir, name), w[m])
            x0, y0 = key[0] * tile, key[1] * tile
            rows.append(f"{name},{x0},{y0},0,{x0 + tile},{y0 + tile},0")
        with open(os.path.join(out_dir, f"{fam}_arealist.csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
        written[fam] = (len(w), len(rows))
    return written


def floor_groups(n_frames, floor_labels=""):
    """{label: keyframe indices}: each non-negative label of the floor-label
    file builds its own map (OccupancyServerFromFile :445-595); without a
    file every keyframe is on floor 0."""
    if not floor_labels:
        return {0: list(range(n_frames))}
    labels = np.loadtxt(floor_labels, dtype=np.int64).reshape(-1)
    groups = {}
    for k in range(min(n_frames, len(labels))):
        if labels[k] >= 0:
            groups.setdefault(int(labels[k]), []).append(k)
    return groups


def occupancy_map(kf: Keyframes, cfg, idxs):
    """One 2-D occupancy grid from the keyframes `idxs`, each seen from its
    pose's (x, y) at yaw 0, in chunks of NP points (as the JAX app)."""
    import torch

    from pointcloud_slam_tpu_torch.maps import occupancy

    grid = occupancy.create(cfg, device=kf.world.device)
    for k in idxs:
        w = kf.cloud(k)
        xy = np.asarray(kf.poses[k, :, 3][:2], np.float32)
        for i in range(0, w.shape[1], NP):
            chunk = w[:, i : i + NP]
            grid = occupancy.insert_cloud(cfg, grid, chunk, torch.ones(chunk.shape[1], dtype=torch.bool,
                                                                       device=chunk.device), xy, 0.0)
    return grid


def octomap(kf: Keyframes, vcfg):
    """The 3-D hash occupancy of every keyframe, carved from its pose's
    origin in chunks of NP points. Returns (map, slot collisions: a 0-d
    device tensor, see `maps.tiled._slot_update`)."""
    import torch

    from pointcloud_slam_tpu_torch.maps import tiled

    dev = kf.world.device
    vmap = tiled.create_3d(vcfg, device=dev)
    collisions = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(len(kf.names)):
        w = kf.cloud(k)
        origin = np.asarray(kf.poses[k, :, 3], np.float32)
        for i in range(0, w.shape[1], NP):
            chunk = w[:, i : i + NP]
            vmap = tiled.insert_cloud_3d(vcfg, vmap, chunk, torch.ones(chunk.shape[1], dtype=torch.bool, device=dev),
                                         origin, collisions)
    return vmap, collisions


def main(argv=None):
    args = parse_args(argv)
    import torch

    from pointcloud_slam_tpu_torch import convert
    from pointcloud_slam_tpu_torch.io import pcd as pcdio
    from pointcloud_slam_tpu_torch.maps import occupancy, octomap_io, tiled

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    kf = load_keyframes(args.keyframe_dir, args.poses, device)
    print(f"{len(kf.names)} keyframes -> {kf.world.shape[1]} points  device: {device}")

    full = full_map(kf, args.leaf)
    pcdio.write_pcd(args.out, full)
    print(f"full map ({len(full)} pts after {args.leaf} m leaf) -> {args.out}")

    if args.feature_maps:
        for fam, (n_pts, n_tiles) in feature_maps(args.keyframe_dir, kf, args.feature_maps, args.tile).items():
            print(f"{fam} feature map: {n_pts} pts, {n_tiles} tiles -> {args.feature_maps}")

    if args.occupancy:
        cfg = occupancy.OccupancyConfig(size=args.occ_size, resolution=args.occ_res,
                                        origin=-args.occ_size * args.occ_res / 2)
        for label, idxs in sorted(floor_groups(len(kf.names), args.floor_labels).items()):
            out = args.occupancy + ("" if label == 0 else str(label))
            occupancy.save_pgm(cfg, occupancy_map(kf, cfg, idxs), out)
            print(f"occupancy map (floor {label}, {len(idxs)} keyframes) -> {out}.pgm/.yaml")

    if args.bt:
        vcfg = tiled.VoxelOccConfig(capacity=1 << 20, resolution=args.bt_res)
        vmap, collisions = octomap(kf, vcfg)
        n_nodes = octomap_io.save_bt(args.bt, vcfg, convert.to_numpy(vmap))
        print(f"octomap .bt ({n_nodes} nodes, res {args.bt_res} m, {int(collisions)} slot collisions) -> {args.bt}")


if __name__ == "__main__":
    main()
