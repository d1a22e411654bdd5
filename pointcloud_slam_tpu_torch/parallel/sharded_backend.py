"""Factor-sharded pose-graph solve over a device mesh (port of
`pointcloud_slam_tpu/parallel/sharded_backend.py`).

The factor set (odometry, loop, IMU and bias-walk factors) is split across
the ranks of an axis by slot: each rank linearizes, the IMU factors'
forward-mode Jacobians included, only its keyframe and loop slots and
scatters them into partial sums. The chain preconditioner's sub-diagonal
blocks, the right-hand side, the 15x15 diagonal blocks and every PCG
H @ v are all-reduced; the priors and GPS terms are added once, after the
sum. Node state stays replicated (at 4,096 keyframes an H @ v all-reduce
moves 240 KiB), as do the chain factorization, the PCG vectors, the trust
region and the retraction.
"""

from __future__ import annotations

import torch

from ..models.liosam import backend as bk
from . import mesh as mesh_mod


def sharded_optimize(mesh, cfg: bk.BackendConfig, g: bk.PoseGraph, axis: str = "sp") -> bk.PoseGraph:
    """Gauss-Newton / PCG over the whole graph with its factors sharded on
    `axis`: rank r of n linearizes keyframe slots [r KFc, (r + 1) KFc) and
    loop slots [r Lc, (r + 1) Lc), KFc = ceil(KF / n), Lc = ceil(L / n).
    g must be the same on every rank; returns the solved graph, the same on
    every rank."""
    n, r = mesh_mod.axis_size(mesh, axis), mesh.get_local_rank(axis)
    dev = g.t.device
    kf_c = -(-cfg.max_keyframes // n)
    l_c = -(-g.loop_i.shape[0] // n)
    kf_slots = r * kf_c + torch.arange(kf_c, device=dev)
    loop_slots = r * l_c + torch.arange(l_c, device=dev)
    return bk._gauss_newton(cfg, g, cfg.gn_iterations, cfg.pcg_iterations, kf_slots, loop_slots,
                            mesh_mod.psum(mesh, axis))
