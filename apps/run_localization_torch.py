#!/usr/bin/env python
"""Prior-map localization on the PyTorch/CUDA port — the counterpart of
`apps/run_localization.py` (the localization / new_localization node role),
same flags, plus `--device`.

Reference: `src/jueying_slam/src/localization.cpp`
  - dynamic tile-map loading around the pose (`dynamic_load_map_run` :281-315
    + dynamic_map.h): tiles are re-selected when the robot moves, cropped to
    1.1x max_range, and rebuilt into the device maps,
  - `Matching_method` switch loam|ndt (:317-340, :991),
  - fitness gating + relocalize-from-initialPose + lose flag (:424-476),
  - GPS initialization with covariance gate (`gpsHandler` :499),
  - the status channel: fitness/eigen exported per frame (:1243-1244).

Inputs: --map_dir with arealist.csv + tile PCDs (or --map_pcd, one map
PCD; or --feature_map_dir with corner/surf tile maps for feature LOAM),
frames from --data_dir (frame_%06d.pcd) or --synthetic N. Outputs under
--out_dir: the TUM trajectory and status.csv (t, fitness, matched_frac,
lost, max_eigen). A frame reads the device twice, as the JAX app does: the
pose for tile selection and the loss flag; the status rows stay on the
device until the run ends.

    python apps/run_localization_torch.py --synthetic 16 --method ndt     # on the GPU
    python apps/run_localization_torch.py --map_pcd map.pcd --data_dir seq --method loam
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--map_dir", default="", help="tile map dir with arealist.csv")
    p.add_argument("--map_pcd", default="", help="single prior map PCD")
    p.add_argument("--feature_map_dir", default="", help="corner/surf feature tile map dir "
                   "(corner_arealist.csv / surf_arealist.csv): enables the feature-based LOAM path "
                   "(the globalCornerMap/globalSurfMap products new_localization.cpp:309-321 loads); "
                   "implies --method loam")
    p.add_argument("--data_dir", default="")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--method", default="ndt", choices=["loam", "ndt"])
    p.add_argument("--init_pose", default="0,0,0,0", help="x,y,z,yaw initial pose")
    p.add_argument("--gps_init", default="", help="x,y,z[,cov] GPS init (cov gate 0.003, gpsHandler :499)")
    p.add_argument("--ukf_odom", default="", help="CSV of external UKF odometry rows "
                   "(t,x,y,z,qw,qx,qy,qz): refreshes the relocalization pose (UKFHandler :482)")
    p.add_argument("--lever_arm", default="0,0,0", help="Pil lidar-in-body lever arm (m)")
    p.add_argument("--out_dir", default="loc_out")
    p.add_argument("--n_points", type=int, default=8192)
    p.add_argument("--n_corner", type=int, default=512, help="LOAM corner-channel budget")
    p.add_argument("--n_surf", type=int, default=2048, help="LOAM surf-channel budget")
    p.add_argument("--n_scan", type=int, default=16, help="range-image rings (N_SCAN)")
    p.add_argument("--horizon", type=int, default=1800, help="range-image columns (Horizon_SCAN)")
    p.add_argument("--fov_up", type=float, default=15.0)
    p.add_argument("--fov_down", type=float, default=-15.0)
    p.add_argument("--max_range", type=float, default=50.0)
    p.add_argument("--update_map_dist", type=float, default=10.0, help="re-tile when moved this far")
    p.add_argument("--tile_margin", type=float, default=100.0)
    p.add_argument("--device", default="cuda", help="torch device localization runs on")
    return p.parse_args(argv)


def build_config(args):
    """LocalizationConfig for the flags; feature tile maps use stencil-baked
    grids (built once per map update, queried every frame)."""
    from pointcloud_slam_tpu_torch.models.liosam import scan2map as s2m
    from pointcloud_slam_tpu_torch.models.localization import pipeline as loc

    cfg = loc.LocalizationConfig(method="loam" if args.feature_map_dir else args.method)
    if args.feature_map_dir:
        cfg = dataclasses.replace(cfg, scan2map=dataclasses.replace(
            cfg.scan2map, corner_grid=s2m.baked_grid(cfg.scan2map.corner_grid),
            surf_grid=s2m.baked_grid(cfg.scan2map.surf_grid)))
    return cfg


class TileMapLoader:
    """Host-side stand-in for the dynamic map-load thread: keeps the device
    maps built from the tiles around the current position."""

    def __init__(self, args, cfg, device):
        from pointcloud_slam_tpu_torch.io import pcd

        self.args = args
        self.cfg = cfg
        self.device = device
        self.pcdio = pcd
        self.last_xy = None
        self.areas = pcd.read_arealist(os.path.join(args.map_dir, "arealist.csv")) if args.map_dir else None
        self.single = None
        # feature tile maps (the globalCornerMap / globalSurfMap tile
        # products, new_localization.cpp:309-321)
        self.feat_areas = None
        if args.feature_map_dir:
            self.feat_areas = {}
            for fam in ("corner", "surf"):
                path = os.path.join(args.feature_map_dir, f"{fam}_arealist.csv")
                self.feat_areas[fam] = pcd.read_arealist(path) if os.path.exists(path) else []
        self.maps = None
        self.feat_maps = None

    def _crop(self, cloud, x, y):
        """Crop to 1.1 x max_range around the pose (dynamic_load_map :256-280)."""
        r = 1.1 * self.args.max_range
        sel = (np.abs(cloud[:, 0] - x) < r) & (np.abs(cloud[:, 1] - y) < r)
        return cloud[sel] if sel.any() else cloud[:1]

    def _gather_tiles(self, areas, base_dir, x, y):
        tiles = self.pcdio.tiles_for_position(areas, x, y, margin=self.args.tile_margin)
        clouds = [self.pcdio.read_pcd_xyz(os.path.join(base_dir, a["path"])) for a in tiles]
        return np.concatenate(clouds) if clouds else np.zeros((1, 3), np.float32)

    def _moved(self, x, y, maps):
        return (maps is None or self.last_xy is None
                or np.hypot(x - self.last_xy[0], y - self.last_xy[1]) >= self.args.update_map_dist)

    def _soa(self, cloud):
        import torch

        return torch.from_numpy(np.ascontiguousarray(cloud.astype(np.float32).T)).to(self.device)

    def maybe_update_features(self, x, y):
        """Device corner/surf maps from the feature tiles around (x, y)."""
        if not self._moved(x, y, self.feat_maps):
            return self.feat_maps
        self.last_xy = (x, y)
        import torch

        from pointcloud_slam_tpu_torch import ops

        maps = {}
        for fam, grid_cfg in (("corner", self.cfg.scan2map.corner_grid), ("surf", self.cfg.scan2map.surf_grid)):
            cloud = (self._gather_tiles(self.feat_areas[fam], self.args.feature_map_dir, x, y)
                     if self.feat_areas[fam] else np.zeros((1, 3), np.float32))
            pts = self._soa(self._crop(cloud.astype(np.float32), x, y))
            grid = ops.create(grid_cfg, dtype=pts.dtype, device=self.device)
            maps[fam] = ops.insert(grid_cfg, grid, pts, torch.ones(pts.shape[1], dtype=torch.bool, device=self.device))
        self.feat_maps = (maps["corner"], maps["surf"])
        return self.feat_maps

    def maybe_update(self, x, y):
        """(point grid config, point map, NDT grid config, baked NDT map)
        around (x, y), rebuilt when the robot moved update_map_dist."""
        if not self._moved(x, y, self.maps):
            return self.maps
        self.last_xy = (x, y)
        if self.areas is not None:
            cloud = self._gather_tiles(self.areas, self.args.map_dir, x, y)
        else:
            if self.single is None:
                self.single = self.pcdio.read_pcd_xyz(self.args.map_pcd)
            cloud = self.single
        self.maps = self._build(self._crop(cloud.astype(np.float32), x, y))
        return self.maps

    def _build(self, cloud):
        from pointcloud_slam_tpu_torch import register

        pts = self._soa(cloud)
        # LOAM matches against cfg.scan2map.surf_grid, so the point map is
        # built on that grid config; the fitness score of both methods reads it
        grid_cfg, point_map = register.build_target_map(pts, grid_cfg=self.cfg.scan2map.surf_grid)
        # baked: built once per map update, queried every frame
        ndt_grid, ndt_map = register.ndt.build_target(self.cfg.ndt, pts, capacity=1 << 15, baked=True)
        return grid_cfg, point_map, ndt_grid, ndt_map


def synthetic_frames(args, loader):
    """The JAX app's synthetic replay: 60,000-point room, scans of n_points
    room points seen from (0.1 k, 0.05 k, 0); the loader localizes against
    the same room. Yields (stamp, (N, 3) scan)."""
    from pointcloud_slam_tpu_torch.io import synthetic

    world = synthetic.make_room_cloud(60_000, seed=0)
    loader.single = world
    loader.areas = None
    rng = np.random.default_rng(1)
    for k in range(args.synthetic):
        t = np.array([0.1 * k, 0.05 * k, 0.0], np.float32)
        sel = rng.choice(len(world), args.n_points, replace=False)
        yield k * 0.1, (world[sel] - t).astype(np.float32)


def dir_frames(args):
    from pointcloud_slam_tpu_torch.io import pcd

    files = sorted(f for f in os.listdir(args.data_dir) if f.startswith("frame_") and f.endswith(".pcd"))
    for k, name in enumerate(files):
        yield k * 0.1, pcd.read_pcd_xyz(os.path.join(args.data_dir, name))


def main(argv=None):
    args = parse_args(argv)
    import torch

    from pointcloud_slam_tpu_torch import ops
    from pointcloud_slam_tpu_torch.geom import se3, so3
    from pointcloud_slam_tpu_torch.io import odom_feed
    from pointcloud_slam_tpu_torch.models.liosam import features, projection
    from pointcloud_slam_tpu_torch.models.localization import pipeline as loc
    from pointcloud_slam_tpu_torch.utils import checkpoint as ck

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    if not (args.synthetic > 0 or args.data_dir):
        raise SystemExit("give --data_dir or --synthetic N")
    os.makedirs(args.out_dir, exist_ok=True)
    cfg = build_config(args)

    def pose_at(pos, yaw):
        return se3.Pose(so3.exp(torch.tensor([0.0, 0.0, yaw], dtype=torch.float32, device=device)),
                        torch.as_tensor(np.asarray(pos, np.float32), device=device))

    lever = tuple(float(v) for v in args.lever_arm.split(","))
    x0, y0, z0, yaw0 = (float(v) for v in args.init_pose.split(","))
    if args.gps_init:
        vals = [float(v) for v in args.gps_init.split(",")]
        cov = vals[3] if len(vals) > 3 else 0.0
        pos = odom_feed.gps_init_position(vals[:3], (cov, cov), lever_arm=lever)
        if pos is not None:  # covariance gate (localization.cpp gpsHandler :499-520)
            x0, y0, z0 = (float(v) for v in pos)
            print(f"GPS init accepted: ({x0:.2f}, {y0:.2f}, {z0:.2f})")
        else:
            print(f"GPS init REJECTED (cov {cov} >= {odom_feed.GPS_COV_GATE})")
    ukf = odom_feed.UkfOdomFeed.from_csv(args.ukf_odom, lever_arm=lever) if args.ukf_odom else None
    init = pose_at([x0, y0, z0], yaw0)

    loader = TileMapLoader(args, cfg, device)
    # in-loop LOAM front end: range-image projection + feature extraction,
    # the stages new_localization runs before corner/surf matching
    pcfg = projection.ProjectionConfig(n_scan=args.n_scan, horizon=args.horizon, fov_up_deg=args.fov_up,
                                       fov_down_deg=args.fov_down, min_range=0.5)
    fcfg = features.FeatureConfig()
    # LOAM against a raw tile: surf-plane matching only (raw tiles carry no feature split)
    empty_corner = ops.create(cfg.scan2map.corner_grid, device=device)
    no_c = torch.zeros((3, 8), dtype=torch.float32, device=device)
    no_cm = torch.zeros(8, dtype=torch.bool, device=device)

    pose = init
    stamps, status, poss, rots = [], [], [], []
    n_lost = 0
    t_start = time.perf_counter()
    for stamp, pts in (synthetic_frames(args, loader) if args.synthetic > 0 else dir_frames(args)):
        P = args.n_points
        buf = np.zeros((3, P), np.float32)
        k = min(len(pts), P)
        buf[:, :k] = pts[:k].T
        pj = torch.from_numpy(buf).to(device)
        mj = torch.from_numpy(np.arange(P) < k).to(device)

        x, y = pose.t[:2].tolist()     # host read 1: tile selection
        if cfg.method == "ndt":
            grid_cfg, point_map, ndt_grid, ndt_map = loader.maybe_update(x, y)
            res = loc.localize_ndt(cfg, ndt_grid, ndt_map, grid_cfg, point_map, pj, mj, pose)
        elif args.feature_map_dir:
            corner_map, surf_map = loader.maybe_update_features(x, y)
            cpts, cmask, spts, smask = features.front_end(pcfg, fcfg, pj, mj)
            # spread over every ring, as the SLAM app selects (the first n in
            # ring order would keep the lowest rings only)
            c, cm = features.spread_size(cpts, cmask, args.n_corner)
            s, sm = features.spread_size(spts, smask, args.n_surf)
            res = loc.localize_loam(cfg, None, corner_map, surf_map, c, cm, s, sm, pose)
        else:
            grid_cfg, point_map, _, _ = loader.maybe_update(x, y)
            res = loc.localize_loam(cfg, grid_cfg, empty_corner, point_map, no_c, no_cm, pj, mj, pose)
        # on loss restart from initialPose; with a UKF stream, from the latest
        # lever-arm-corrected UKF pose (UKFHandler :482 feeding :441-476)
        fallback = init
        if ukf is not None:
            got = ukf.initial_pose_at(stamp)
            if got is not None:
                fallback = pose_at(*got)
        pose = loc.relocalize(res, fallback)
        n_lost += bool(res.lost)       # host read 2: the loss flag
        stamps.append(stamp)
        status.append(torch.stack([res.fitness, res.matched_frac, res.lost.to(res.fitness.dtype), res.max_eigen]))
        poss.append(pose.t)
        rots.append(pose.R)
    if not stamps:
        raise SystemExit("no frames to localize")
    rows = torch.stack(status).cpu().numpy()     # one read back for the whole run
    pos = torch.stack(poss).cpu().numpy()
    quats = so3.to_quat(torch.stack(rots)).cpu().numpy()
    wall = time.perf_counter() - t_start
    n = len(stamps)
    print(f"frames: {n}  wall: {wall:.1f}s  FPS: {n / max(wall, 1e-9):.2f}  lost: {n_lost}  device: {device}")
    with open(os.path.join(args.out_dir, "status.csv"), "w") as f:
        f.write("t,fitness,matched_frac,lost,max_eigen\n")
        for stamp, (fit, frac, lost, eig) in zip(stamps, rows):
            f.write(f"{stamp},{float(fit)},{float(frac)},{int(lost)},{float(eig)}\n")
    ck.save_trajectory_tum(os.path.join(args.out_dir, "traj_tum.txt"), stamps, pos, quats)
    print(f"outputs -> {args.out_dir}/ (traj_tum.txt, status.csv)")


if __name__ == "__main__":
    main()
