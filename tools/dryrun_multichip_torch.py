#!/usr/bin/env python
"""Multi-rank dry run of the PyTorch/CUDA port's sharded paths — the
counterpart of `__graft_entry__.dryrun_multichip`: the same four calls at
the same shapes, and the same summary line.

`--world_size` ranks (default 4) are spawned by `parallel.launch` on a
(dp, sp) mesh: point-to-plane ICP with the batch on dp and the points on
sp (3 GN iterations), the LIO iterated-ESKF update and LOAM scan-to-map
with their point axes on sp, and the factor-sharded backend on a
1,024-keyframe drifting circle with 12 loops (2 GN x 12 PCG; its error
must fall). The maps and the graph are built once and broadcast from
rank 0. Rank 0 prints the summary; every rank's outputs must be equal.

    python tools/dryrun_multichip_torch.py                     # on the GPU
    python tools/dryrun_multichip_torch.py --device cpu        # gloo on the CPU

On the GPU the ranks share the cards: with more ranks than cards they use
gloo (NCCL needs a card per rank), else NCCL, unless --backend says.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

TIMEOUT_S = 600.0   # the ranks must be done within this


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--world_size", type=int, default=4, help="ranks to spawn")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help="where the ranks run")
    p.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                   help="process-group backend (default: NCCL when every rank has a card, else gloo)")
    return p.parse_args(argv)


def dryrun_rank(device):
    """One rank of the dry run; returns (summary line, outputs)."""
    import torch
    import torch.distributed as dist

    from pointcloud_slam_tpu_torch import ops, parallel, register
    from pointcloud_slam_tpu_torch.geom import se3
    from pointcloud_slam_tpu_torch.io import synthetic
    from pointcloud_slam_tpu_torch.models import lio
    from pointcloud_slam_tpu_torch.models.liosam import backend as bk
    from pointcloud_slam_tpu_torch.models.liosam import scan2map as s2m
    from pointcloud_slam_tpu_torch.parallel import mesh as pmesh

    dev = torch.device(device)
    mesh = parallel.make_mesh(device_type=device)
    dp, sp = pmesh.axis_size(mesh, "dp"), pmesh.axis_size(mesh, "sp")

    grid_cfg = ops.GridConfig(capacity=1 << 10, pts_per_voxel=8, resolution=0.5, nearby=7)
    world = synthetic.make_room_cloud(2_000, seed=0)
    _, grid = register.build_target_map(torch.from_numpy(np.ascontiguousarray(world.T)).to(dev), grid_cfg=grid_cfg)
    grid = pmesh.replicate(grid)

    B, N = dp * 2, sp * 128
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.choice(world, size=(B, N)).transpose(0, 2, 1).astype(np.float32)).to(dev)
    cfg = register.ICPConfig(solver=register.SolverConfig(max_iterations=3))
    pose, conv, iters = parallel.sharded_point_to_plane_icp(
        mesh, grid_cfg, grid, src, torch.ones((B, N), dtype=torch.bool, device=dev),
        se3.identity(batch=(B,), device=dev), cfg=cfg)
    assert pose.t.shape == (B, 3)

    # point-axis sharded LIO iterated-ESKF update
    lcfg = lio.LIOConfig(grid=grid_cfg, init_imu_frames=1)
    s0 = lio.create_state(lcfg, device=dev)
    pts_body = torch.from_numpy(
        (rng.choice(world, size=sp * 256) - np.array([0.05, -0.02, 0.01])).T.astype(np.float32)).to(dev)
    x_sh, _, _, _ = parallel.sharded_lio_update(mesh, lcfg, grid, s0.x, s0.P, pts_body,
                                                torch.ones(pts_body.shape[1], dtype=torch.bool, device=dev))

    # point-axis sharded LOAM scan-to-map
    s2m_cfg = s2m.Scan2MapConfig(corner_grid=grid_cfg, surf_grid=grid_cfg,
                                 solver=register.SolverConfig(max_iterations=4))
    feat = torch.from_numpy(rng.choice(world, size=sp * 64).T.astype(np.float32)).to(dev)
    fmask = torch.ones(feat.shape[1], dtype=torch.bool, device=dev)
    s2m_res = parallel.sharded_scan_to_map(mesh, s2m_cfg, grid, grid, feat, fmask, feat, fmask,
                                           se3.identity(device=dev))

    # factor-sharded pose-graph backend: each rank linearizes its slot shard
    KF, L, NL = 1024, 32, 12
    bcfg = bk.BackendConfig(max_keyframes=KF, max_loops=L, gn_iterations=2, pcg_iterations=12)
    graph, t_true, t_noisy = synthetic.drifting_circle_graph(bcfg, NL, 80, 512, rng=rng, device=dev)
    graph = pmesh.replicate(graph)
    solved = parallel.sharded_optimize(mesh, bcfg, graph)
    err0 = float(np.linalg.norm(t_noisy - t_true, axis=1).max())
    err1 = float(np.linalg.norm(solved.t.cpu().numpy() - t_true, axis=1).max())
    assert err1 < err0, (err0, err1)

    # active factors in each slot shard of the sp axis (JAX's line divides
    # the slots by every device of the mesh, not by the axis it shards on)
    n_sh = sp
    KFc, Lc = -(-KF // n_sh), -(-L // n_sh)
    shard_counts = []
    for r in range(n_sh):
        ks = np.arange(r * KFc, (r + 1) * KFc)
        ls = np.arange(r * Lc, (r + 1) * Lc)
        shard_counts.append(int(((ks >= 1) & (ks < KF)).sum()) + int((ls < NL).sum()))
    line = (f"dryrun_multichip ok: mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
            f"pose_t_norm={float(torch.linalg.norm(pose.t)):.4f} "
            f"lio_pos={np.round(x_sh.pos.cpu().numpy(), 4).tolist()} "
            f"backend_1k err {err0:.3f}->{err1:.3f} m, factors/device={shard_counts} "
            f"world={dist.get_world_size()} backend={dist.get_backend()} device={device}")
    return line, (pose.R, pose.t, conv, iters, tuple(x_sh), s2m_res.pose.t, solved.t)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from pointcloud_slam_tpu_torch import parallel

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    outs = parallel.launch(dryrun_rank, args.world_size, device=args.device, backend=args.backend,
                           args=(args.device,), timeout=TIMEOUT_S)

    def flat(tree):
        return [tree] if isinstance(tree, torch.Tensor) else [t for v in tree for t in flat(v)]

    for r, (_, out) in enumerate(outs[1:], 1):
        for a, b in zip(flat(outs[0][1]), flat(out)):
            if not torch.equal(a, b):
                raise SystemExit(f"rank {r}'s outputs differ from rank 0's")
    print(outs[0][0])


if __name__ == "__main__":
    main()
