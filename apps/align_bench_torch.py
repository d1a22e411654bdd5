#!/usr/bin/env python
"""Side-by-side registration benchmark on the PyTorch/CUDA port — the
counterpart of `apps/align_bench.py` (the fast_gicp align.cpp role): every
ported registration family on the same source/target pair, with
single-shot and repeated timings, the fitness score and, on the synthetic
pair, the translation error against the known offset.

Input: --target/--source PCDs (each subsampled to min(len(target),
len(source), --n_points) points, as the JAX app picks them), or the
synthetic pair. Rows: point_to_plane_icp, ndt_p2d, ndt_d2d, vgicp (knn
cov), vgicp (rbf cov), vgicp (exact/pallas cov) — exact covariances from
kernel K1 on the GPU —, cov: voxel knn, cov: exact knn, cov: rbf, gicp.

    python apps/align_bench_torch.py                                  # on the GPU
    python apps/align_bench_torch.py --target a.pcd --source b.pcd
    python apps/align_bench_torch.py --device cpu --n_points 3000 --reps 1
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--target", default="", help="target PCD (with --source; default: the synthetic pair)")
    p.add_argument("--source", default="", help="source PCD, aligned onto the target")
    p.add_argument("--n_points", type=int, default=17_000, help="~align.cpp's KITTI pair size")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--leaf", type=float, default=0.1,
                   help="accepted for parity with apps/align_bench.py, which does not use it either: "
                        "no downsampling is applied")
    p.add_argument("--device", default="cuda", help="torch device the registrations run on")
    return p.parse_args(argv)


def on_device(tgt, src, device):
    """A (n, 3) target and source on the device in the registrations'
    layout, with a 0.5 m voxel map of the target for fitness_score:
    (src (3, N), tgt (3, N), mask (N,), fit_grid, fit_map)."""
    import torch

    from pointcloud_slam_tpu_torch import ops, register

    tgt_t = torch.from_numpy(np.ascontiguousarray(tgt.T.astype(np.float32))).to(device)
    src_t = torch.from_numpy(np.ascontiguousarray(src.T.astype(np.float32))).to(device)
    mask = torch.ones(src_t.shape[1], dtype=torch.bool, device=device)
    fit_grid = ops.GridConfig(capacity=1 << 16, pts_per_voxel=8, resolution=0.5, nearby=7)
    _, fit_map = register.build_target_map(tgt_t, grid_cfg=fit_grid)
    return src_t, tgt_t, mask, fit_grid, fit_map


def make_pair(n_points, device):
    """The synthetic pair of apps/align_bench.py: n_points target and source
    points drawn from a 40,000-point room, the source offset by
    random_pose(seed=1, 0.05, 0.3), through `on_device`. Returns (src (3,
    N), tgt (3, N), mask (N,), true t (3,) numpy, fit_grid, fit_map)."""
    from pointcloud_slam_tpu_torch.io import synthetic

    world = synthetic.make_room_cloud(40_000, seed=0)
    R, t = synthetic.random_pose(seed=1, rot_scale=0.05, trans_scale=0.3)
    rngl = np.random.default_rng(0)
    tgt = world[rngl.choice(len(world), n_points, replace=False)]
    src = (world[rngl.choice(len(world), n_points, replace=False)] - t) @ R
    src_t, tgt_t, mask, fit_grid, fit_map = on_device(tgt, src, device)
    return src_t, tgt_t, mask, t, fit_grid, fit_map


def load_pair(target, source, n_points):
    """A PCD pair as apps/align_bench.py reads it: n = min(len(target),
    len(source), n_points) points of each, picked by one
    np.random.default_rng(0), the target's first. Returns (tgt (n, 3),
    src (n, 3)) float32 numpy."""
    from pointcloud_slam_tpu_torch.io import pcd

    tgt, src = pcd.read_pcd_xyz(target), pcd.read_pcd_xyz(source)
    n = min(len(tgt), len(src), n_points)
    rngl = np.random.default_rng(0)
    tgt = tgt[rngl.choice(len(tgt), n, replace=False)]
    src = src[rngl.choice(len(src), n, replace=False)]
    return tgt, src


def main(argv=None):
    """Runs every row; returns [(name, single ms, avg ms, fitness, terr or
    None, estimated translation (3,))]."""
    args = parse_args(argv)
    if bool(args.target) != bool(args.source):
        raise SystemExit("give both --target and --source, or neither (the synthetic pair)")
    import torch

    from pointcloud_slam_tpu_torch import register

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if args.target:   # no ground truth: no terr
        src_t, tgt_t, mask, fit_grid, fit_map = on_device(*load_pair(args.target, args.source, args.n_points), device)
        t = None
    else:
        src_t, tgt_t, mask, t, fit_grid, fit_map = make_pair(args.n_points, device)

    def fitness(pose):
        f, _ = register.fitness_score(fit_grid, fit_map, pose.apply(src_t), mask, max_range=1.0)
        return float(f)

    rows = []

    def run(name, solve):
        pose = solve()  # warm-up (first kernel build and launch)
        sync()
        t0 = time.perf_counter()
        pose = solve()
        sync()
        single = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for _ in range(args.reps):
            pose = solve()
            sync()
        avg = (time.perf_counter() - t0) / args.reps * 1e3
        est = pose.t.cpu().numpy()
        terr = None if t is None else float(np.linalg.norm(est - t))
        rows.append((name, single, avg, fitness(pose), terr, est))
        err = "" if terr is None else f"  terr={terr:.4f}"
        print(f"{name:26s} {single:9.2f} ms {avg:9.2f} ms   fitness {rows[-1][3]:.4f}{err}", flush=True)

    icp_cfg = register.ICPConfig(solver=register.SolverConfig(max_iterations=30))
    run("point_to_plane_icp", lambda: register.point_to_plane_icp(fit_grid, fit_map, src_t, cfg=icp_cfg).pose)

    # stencil-baked targets (the serving-path layout; identical results)
    ncfg = register.NDTConfig(resolution=1.0)
    ng, nmap = register.ndt.build_target(ncfg, tgt_t, capacity=1 << 15, baked=True)
    run("ndt_p2d", lambda: register.ndt.align(ng, nmap, src_t, cfg=ncfg).pose)
    sm, sc, sv, _ = register.ndt.voxelize_source(ncfg, src_t)
    run("ndt_d2d", lambda: register.ndt.align_d2d(ng, nmap, sm, sc, sv, cfg=ncfg).pose)

    vcfg = register.VGICPConfig(resolution=1.0)
    vg, vmap = register.vgicp.build_target(vcfg, tgt_t, capacity=1 << 15, baked=True)
    cov_knn = register.source_covariances(src_t, mask, k=8, resolution=1.0)
    run("vgicp (knn cov)", lambda: register.vgicp.align(vg, vmap, src_t, cov_knn, mask, cfg=vcfg).pose)
    cov_rbf = register.source_covariances_rbf(src_t, mask, resolution=1.0, kernel_width=0.5)
    run("vgicp (rbf cov)", lambda: register.vgicp.align(vg, vmap, src_t, cov_rbf, mask, cfg=vcfg).pose)
    cov_exact = register.source_covariances(src_t, mask, k=8, method="exact")
    run("vgicp (exact/pallas cov)", lambda: register.vgicp.align(vg, vmap, src_t, cov_exact, mask, cfg=vcfg).pose)

    # covariance estimation alone (fast_gicp README.md:119-123 compares
    # kdtree / bruteforce / RBF on an RTX 2080 Ti)
    for name, cov in (("cov: voxel knn", lambda: register.source_covariances(src_t, mask, k=8, resolution=1.0)),
                      ("cov: exact knn", lambda: register.source_covariances(src_t, mask, k=8, method="exact")),
                      ("cov: rbf", lambda: register.source_covariances_rbf(src_t, mask, resolution=1.0,
                                                                             kernel_width=0.5))):
        cov()
        sync()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            cov()
            sync()
        print(f"{name:26s} {'':9s}    {(time.perf_counter() - t0) / args.reps * 1e3:9.2f} ms", flush=True)

    gcfg = register.GICPConfig()
    ggrid_cfg, ggrid, gatt = register.gicp.build_target(gcfg, tgt_t)
    run("gicp", lambda: register.gicp.align(ggrid_cfg, ggrid, gatt, src_t, cov_knn, mask, cfg=gcfg).pose)

    print(f"\nalgorithm                    single       avg{args.reps}      fitness   (device {device})")
    for name, single, avg, f, terr, _ in rows:
        print(f"{name:26s} {single:9.2f} {avg:9.2f}   {f:.4f}" + ("" if terr is None else f"  terr={terr:.4f}"))
    return rows


if __name__ == "__main__":
    main()
