#!/usr/bin/env python
"""Render a mapping/SLAM run to PNG — the rviz role, offline; the PyTorch
port's counterpart of `apps/visualize_run.py`, reading with the port's
`utils.checkpoint`, `io.pcd` and `maps.occupancy`. It is a host program
(numpy and matplotlib): nothing runs on a device, so it takes no `--device`.

The reference inspects runs live in rviz (src/jueying_lio/rviz_cfg/*.rviz,
launch/include/module_rviz.launch) with /path, /cloud_registered and the
loop-constraint MarkerArray (mapOptmization.cpp:1020-1068 visualizeLoopClosure).
This app renders the same products from saved artifacts instead: the
run_slam_offline output directory (graph.g2o + Scans/*.pcd keyframe clouds,
traj_tum.txt) and/or an occupancy PGM/YAML pair.

Views: top-down (x, y) map cloud shaded by height (single-hue sequential),
trajectory polyline, loop-closure chords, start/end markers; optional side
elevation panel (--side) and occupancy underlay (--map_yaml).

Usage:
  python apps/visualize_run_torch.py --run_dir out/ --out viz.png
  python apps/visualize_run_torch.py --g2o out/graph.g2o --map_yaml map.yaml --out viz.png
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from pointcloud_slam_tpu_torch.utils import checkpoint as ck  # noqa: E402

# identity colors (fixed assignment, luminance-separated; text/ink stays neutral)
C_TRAJ = "#1f3a5f"    # trajectory — dark ink blue
C_LOOP = "#c2452d"    # loop chords — warm accent
C_START = "#2d7a4f"   # start marker
C_MAP = plt.get_cmap("Blues")  # height shading — one hue, light->dark


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--run_dir", default="", help="run_slam_offline(_torch) output dir (graph.g2o, Scans/, traj_tum.txt)")
    p.add_argument("--g2o", default="", help="pose graph file (overrides run_dir/graph.g2o)")
    p.add_argument("--traj", default="", help="TUM trajectory file (fallback path source)")
    p.add_argument("--map_yaml", default="", help="occupancy PGM/YAML pair (base path or either file)")
    p.add_argument("--side", action="store_true", help="add an (x, z) elevation panel")
    p.add_argument("--max_points", type=int, default=400_000, help="map-point render budget")
    p.add_argument("--point_size", type=float, default=0.5)
    p.add_argument("--out", default="viz.png")
    p.add_argument("--dpi", type=int, default=150)
    return p.parse_args(argv)


def _load_graph(args):
    """-> (positions (N,3) or None, loop edges [(i, j)], quats or None)."""
    path = args.g2o or (os.path.join(args.run_dir, "graph.g2o") if args.run_dir else "")
    if path and os.path.exists(path):
        ids, ts, qs, edges = ck.load_pose_graph_g2o(path)
        order = np.argsort(ids)
        pos = np.asarray(ts)[order]
        quat = np.asarray(qs)[order]
        id2row = {int(i): r for r, i in enumerate(np.asarray(ids)[order])}
        loops = [(id2row[i], id2row[j]) for (i, j, *_rest) in edges if abs(i - j) > 1]
        return pos, loops, quat
    traj = args.traj or (os.path.join(args.run_dir, "traj_tum.txt") if args.run_dir else "")
    if traj and os.path.exists(traj):
        rows = np.loadtxt(traj)
        if rows.ndim == 1:
            rows = rows[None, :]
        return rows[:, 1:4], [], rows[:, 4:8]
    return None, [], None


def _quat_to_R(q):
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _load_map_cloud(args, pos, quat):
    """Compose keyframe Scans/*.pcd into the world frame. -> (M, 3) or None."""
    scans = os.path.join(args.run_dir, "Scans") if args.run_dir else ""
    if not (scans and os.path.isdir(scans) and pos is not None):
        return None
    from pointcloud_slam_tpu_torch.io import pcd as pcdio

    # Scans/ holds %06d.pcd keyframe clouds plus %06d_corner.pcd feature
    # channels (run_slam_offline --save_artifacts); render the base clouds
    files = sorted(
        f for f in os.listdir(scans)
        if f.endswith(".pcd") and os.path.splitext(f)[0].isdigit()
    )
    out = []
    for f in files:
        k = int(os.path.splitext(f)[0])
        if k >= len(pos):
            continue
        xyz = pcdio.read_pcd_xyz(os.path.join(scans, f))  # (N, 3)
        R = _quat_to_R(quat[k]) if quat is not None else np.eye(3)
        out.append(xyz @ R.T + pos[k])
    if not out:
        return None
    cloud = np.concatenate(out, 0)
    if len(cloud) > args.max_points:
        sel = np.random.default_rng(0).choice(len(cloud), args.max_points, replace=False)
        cloud = cloud[sel]
    return cloud


def _draw_occupancy(ax, map_base):
    """`map_base` is the PGM/YAML pair's base path (load_pgm convention)."""
    from pointcloud_slam_tpu_torch.maps import occupancy as occ

    base = map_base[:-5] if map_base.endswith(".yaml") else map_base
    base = base[:-4] if base.endswith(".pgm") else base
    grid, meta = occ.load_pgm(base)  # (X, Y) trinary int8, module convention
    res = float(meta["resolution"])
    ox, oy = float(meta["origin"][0]), float(meta["origin"][1])
    # display: unknown mid-gray, free light, occupied dark
    img = np.full(grid.shape, 0.82)
    img[grid == -1] = 0.62
    img[grid == 100] = 0.15
    w, h = grid.shape
    ax.imshow(
        img.T, cmap="gray", vmin=0, vmax=1, origin="lower",
        extent=(ox, ox + w * res, oy, oy + h * res), zorder=0, alpha=0.9,
    )


def render(args):
    pos, loops, quat = _load_graph(args)
    cloud = _load_map_cloud(args, pos, quat)

    ncols = 2 if args.side else 1
    fig, axes = plt.subplots(1, ncols, figsize=(9 * ncols, 8), squeeze=False)
    ax = axes[0, 0]
    if args.map_yaml:
        _draw_occupancy(ax, args.map_yaml)
    if cloud is not None:
        z = cloud[:, 2]
        lo, hi = np.percentile(z, [2, 98])
        ax.scatter(
            cloud[:, 0], cloud[:, 1], c=np.clip(z, lo, hi), cmap=C_MAP,
            s=args.point_size, linewidths=0, alpha=0.6, zorder=1, rasterized=True,
        )
    if pos is not None:
        ax.plot(pos[:, 0], pos[:, 1], color=C_TRAJ, lw=2, zorder=3, label="trajectory")
        for (i, j) in loops:
            ax.plot(
                [pos[i, 0], pos[j, 0]], [pos[i, 1], pos[j, 1]],
                color=C_LOOP, lw=1.2, alpha=0.8, zorder=2,
                label="loop closure" if (i, j) == loops[0] else None,
            )
        ax.scatter(*pos[0, :2], color=C_START, s=80, marker="^", zorder=4, label="start")
        ax.scatter(*pos[-1, :2], color=C_TRAJ, s=80, marker="s", zorder=4, label="end")
        ax.legend(loc="upper right", frameon=True, framealpha=0.9)
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    n_loop = len(loops)
    n_kf = 0 if pos is None else len(pos)
    ax.set_title(f"map view — {n_kf} keyframes, {n_loop} loop closures")
    ax.grid(True, lw=0.3, alpha=0.4)

    if args.side:
        ax2 = axes[0, 1]
        if cloud is not None:
            ax2.scatter(cloud[:, 0], cloud[:, 2], c="#9db8d2", s=args.point_size, linewidths=0, alpha=0.5, rasterized=True)
        if pos is not None:
            ax2.plot(pos[:, 0], pos[:, 2], color=C_TRAJ, lw=2)
        ax2.set_xlabel("x [m]")
        ax2.set_ylabel("z [m]")
        ax2.set_title("elevation")
        ax2.grid(True, lw=0.3, alpha=0.4)

    fig.tight_layout()
    fig.savefig(args.out, dpi=args.dpi)
    print(f"render -> {args.out} ({n_kf} keyframes, {n_loop} loops, "
          f"{0 if cloud is None else len(cloud)} map points)")


if __name__ == "__main__":
    render(parse_args())
