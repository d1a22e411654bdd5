#!/usr/bin/env python
"""Side-by-side registration benchmark on the PyTorch/CUDA port — the
counterpart of `apps/align_bench.py` (the fast_gicp align.cpp role): every
ported registration family on the same synthetic source/target pair, with
single-shot and repeated timings, the fitness score and the translation
error against the known offset.

Rows: point_to_plane_icp, vgicp (knn cov), vgicp (exact/pallas cov) — exact
covariances from kernel K1 on the GPU —, cov: voxel knn, cov: exact knn,
gicp. Not ported yet, so not run: the NDT rows (ndt_p2d, ndt_d2d), the RBF
rows (vgicp (rbf cov), cov: rbf) and PCD input (--target/--source).

    python apps/align_bench_torch.py                                  # on the GPU
    python apps/align_bench_torch.py --device cpu --n_points 3000 --reps 1
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="NDT (ndt_p2d, ndt_d2d), the RBF-covariance rows and PCD input are not ported yet.")
    p.add_argument("--n_points", type=int, default=17_000, help="~align.cpp's KITTI pair size")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--device", default="cuda", help="torch device the registrations run on")
    return p.parse_args(argv)


def make_pair(n_points, device):
    """The synthetic pair of apps/align_bench.py: n_points target and source
    points drawn from a 40,000-point room, the source offset by
    random_pose(seed=1, 0.05, 0.3), plus a 0.5 m voxel map of the target for
    fitness_score. Returns (src (3, N), tgt (3, N), mask (N,), true t (3,)
    numpy, fit_grid, fit_map)."""
    import torch

    from pointcloud_slam_tpu_torch import ops, register
    from pointcloud_slam_tpu_torch.io import synthetic

    world = synthetic.make_room_cloud(40_000, seed=0)
    R, t = synthetic.random_pose(seed=1, rot_scale=0.05, trans_scale=0.3)
    rngl = np.random.default_rng(0)
    tgt = world[rngl.choice(len(world), n_points, replace=False)]
    src = (world[rngl.choice(len(world), n_points, replace=False)] - t) @ R
    tgt_t = torch.from_numpy(np.ascontiguousarray(tgt.T.astype(np.float32))).to(device)
    src_t = torch.from_numpy(np.ascontiguousarray(src.T.astype(np.float32))).to(device)
    mask = torch.ones(src_t.shape[1], dtype=torch.bool, device=device)
    fit_grid = ops.GridConfig(capacity=1 << 16, pts_per_voxel=8, resolution=0.5, nearby=7)
    _, fit_map = register.build_target_map(tgt_t, grid_cfg=fit_grid)
    return src_t, tgt_t, mask, t, fit_grid, fit_map


def main(argv=None):
    args = parse_args(argv)
    import torch

    from pointcloud_slam_tpu_torch import register

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

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
        terr = float(np.linalg.norm(pose.t.cpu().numpy() - t))
        rows.append((name, single, avg, fitness(pose), terr))
        print(f"{name:26s} {single:9.2f} ms {avg:9.2f} ms   fitness {rows[-1][3]:.4f}  terr={terr:.4f}", flush=True)

    icp_cfg = register.ICPConfig(solver=register.SolverConfig(max_iterations=30))
    run("point_to_plane_icp", lambda: register.point_to_plane_icp(fit_grid, fit_map, src_t, cfg=icp_cfg).pose)

    vcfg = register.VGICPConfig(resolution=1.0)
    vg, vmap = register.vgicp.build_target(vcfg, tgt_t, capacity=1 << 15, baked=True)
    cov_knn = register.source_covariances(src_t, mask, k=8, resolution=1.0)
    run("vgicp (knn cov)", lambda: register.vgicp.align(vg, vmap, src_t, cov_knn, mask, cfg=vcfg).pose)
    cov_exact = register.source_covariances(src_t, mask, k=8, method="exact")
    run("vgicp (exact/pallas cov)", lambda: register.vgicp.align(vg, vmap, src_t, cov_exact, mask, cfg=vcfg).pose)

    # covariance estimation alone (fast_gicp README.md:119-123 compares
    # kdtree / bruteforce / RBF on an RTX 2080 Ti)
    for name, method in (("cov: voxel knn", "voxel"), ("cov: exact knn", "exact")):
        register.source_covariances(src_t, mask, k=8, resolution=1.0, method=method)
        sync()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            register.source_covariances(src_t, mask, k=8, resolution=1.0, method=method)
            sync()
        print(f"{name:26s} {'':9s}    {(time.perf_counter() - t0) / args.reps * 1e3:9.2f} ms", flush=True)

    gcfg = register.GICPConfig()
    ggrid_cfg, ggrid, gatt = register.gicp.build_target(gcfg, tgt_t)
    run("gicp", lambda: register.gicp.align(ggrid_cfg, ggrid, gatt, src_t, cov_knn, mask, cfg=gcfg).pose)

    print(f"\nalgorithm                    single       avg{args.reps}      fitness   (device {device})")
    for name, single, avg, f, terr in rows:
        print(f"{name:26s} {single:9.2f} {avg:9.2f}   {f:.4f}  terr={terr:.4f}")
    return rows


if __name__ == "__main__":
    main()
