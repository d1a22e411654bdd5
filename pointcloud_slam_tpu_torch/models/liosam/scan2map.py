"""LOAM scan-to-map matching: corner/edge lines + surface planes (port of
`pointcloud_slam_tpu/models/liosam/scan2map.py`).

Reference: `src/jueying_slam/src/mapOptmization.cpp` — `cornerOptimization`
(:1255-1347): 5-NN in the corner map, line fit by covariance
eigendecomposition (valid if l_max > 3 l_mid); `surfOptimization`
(:1349-1419): 5-NN plane fit (A n = -1); `LMOptimization` (:1442-1558):
6-DoF Gauss-Newton with the eigenvalue degeneracy guard (eig < 100 ->
project the update out of those directions); `scan2MapOptimization`
(:1560-1590): iterate matching + GN.

Both feature families become plane-style residual rows [pw x n, n] (for
lines, n is the in-plane perpendicular to the fitted line), one (6, N)
Jacobian block and H = J J^T. The search schedule is static (warm-up rounds
of one iteration, then rounds of `search_every`), with the degeneracy
projector recomputed once per round (`warmup_searches + ceil((max_iterations
- warmup_searches) / search_every)` = 4 eigendecompositions at the defaults,
plus the final eigenvalues: 5 launches of kernel K6 a call on the card,
`ops.small_eigh`); nothing reads back to the host. The JAX package's
`optimization_barrier` guards (a libtpu miscompile workaround) are not
ported.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ... import ops
from ...geom import fit, se3
from ...ops import small_eigh
from ...register import solver


def baked_grid(g: ops.GridConfig) -> ops.GridConfig:
    """Stencil-baked variant of a local-map grid config: same stencil and
    resolution, per-voxel capacity expanded to nearby x pts_per_voxel so the
    baked candidate budget matches the unbaked one (one lookup per query in
    scan_to_map's k-NN)."""
    return dataclasses.replace(g, pts_per_voxel=g.nearby * g.pts_per_voxel, baked=True)


@dataclasses.dataclass(frozen=True)
class Scan2MapConfig:
    corner_grid: ops.GridConfig = dataclasses.field(
        default_factory=lambda: ops.GridConfig(capacity=1 << 15, pts_per_voxel=8, resolution=0.4, nearby=7)
    )
    surf_grid: ops.GridConfig = dataclasses.field(
        default_factory=lambda: ops.GridConfig(capacity=1 << 16, pts_per_voxel=8, resolution=0.8, nearby=7)
    )
    max_corr_dist: float = 1.0       # 5-NN gate (kd-tree radius 1 m in ref)
    plane_threshold: float = 0.2
    line_ratio: float = 3.0
    degeneracy_eig: float = 100.0    # LMOptimization eigen threshold
    search_every: int = 3
    # one-iteration rounds before the regular cadence (fresh correspondences
    # while the init guess is still far; scan2MapOptimization :1560-1590)
    warmup_searches: int = 3
    # 6 GN iterations, not the reference's 30 with a convergence break: the
    # static schedule pays for every iteration (the JAX package's measurement:
    # the same final error at 6 as at 30)
    solver: solver.SolverConfig = dataclasses.field(
        default_factory=lambda: solver.SolverConfig(max_iterations=6, degeneracy_threshold=100.0)
    )


class Scan2MapResult(NamedTuple):
    pose: se3.Pose
    converged: torch.Tensor
    iterations: torch.Tensor
    num_corner: torch.Tensor
    num_surf: torch.Tensor
    H: torch.Tensor
    degenerate: torch.Tensor


def _corner_rows(cfg, grid, pw, mask):
    """Point-to-line correspondences -> plane-style rows (nx, ny, nz, d, s, ok)."""
    nbrs, d2, cnt, _ = ops.knn(cfg.corner_grid, grid, pw, k=5, max_range=cfg.max_corr_dist)
    nmask = torch.arange(d2.shape[0], device=d2.device)[:, None] < cnt[None, :]
    center, direction, line_ok = fit.line_fit(nbrs, nmask, cfg.line_ratio)
    ok = mask & line_ok & (cnt >= 5)
    # perpendicular from the line to the point: u = (p - c) - ((p - c).d) d
    e = pw - center
    u = e - torch.sum(e * direction, dim=0) * direction
    rr = torch.sqrt(torch.clamp(torch.sum(u * u, dim=0), min=1e-12))
    n = torch.where(ok, u / rr, 0.0)
    r = torch.where(ok, rr, 0.0)
    # plane-style offset so the residual recomputes at fresh poses:
    # r_new = n . pw_new + d with d = r_search - n . pw_search
    d_off = r - torch.sum(pw * n, dim=0)
    # robust LOAM weighting s = 1 - 0.9 |r| (mapOptmization.cpp:1330)
    s = torch.where(ok, torch.clamp(1.0 - 0.9 * torch.abs(r), 0.0, 1.0), 0.0)
    return n[0], n[1], n[2], d_off, s, ok


def _surf_rows(cfg, grid, pw, mask):
    nbrs, d2, cnt, _ = ops.knn(cfg.surf_grid, grid, pw, k=5, max_range=cfg.max_corr_dist)
    nmask = torch.arange(d2.shape[0], device=d2.device)[:, None] < cnt[None, :]
    coef, plane_ok = fit.plane_fit(nbrs, nmask, cfg.plane_threshold, 5)
    ok = mask & plane_ok & (cnt >= 5)
    c = torch.where(ok, coef, 0.0)
    r = torch.where(ok, torch.sum(pw * c[:3], dim=0) + c[3], 0.0)
    # robust weight s = 1 - 0.9 |r| / sqrt(|p|) (mapOptmization.cpp:1392)
    pn = torch.sqrt(torch.sqrt(torch.sum(pw * pw, dim=0)) + 1e-9)
    s = torch.where(ok, torch.clamp(1.0 - 0.9 * torch.abs(r) / pn, 0.0, 1.0), 0.0)
    return c[0], c[1], c[2], c[3], s, ok


def _hb(pw, rows):
    """(H (6, 6), b (6,), sum r^2, matched count) of the weighted rows at pw."""
    nx, ny, nz, d_off, s, ok = rows
    r = s * (pw[0] * nx + pw[1] * ny + pw[2] * nz + d_off)
    nx, ny, nz = nx * s, ny * s, nz * s
    J = torch.stack([pw[1] * nz - pw[2] * ny, pw[2] * nx - pw[0] * nz, pw[0] * ny - pw[1] * nx, nx, ny, nz], dim=0)
    return J @ J.T, J @ r, torch.sum(r * r), torch.sum(ok)


def scan_to_map(
    cfg: Scan2MapConfig,
    corner_map: ops.VoxelHashMap,
    surf_map: ops.VoxelHashMap,
    corner_pts: torch.Tensor,   # (3, Nc) sensor frame
    corner_mask: torch.Tensor,
    surf_pts: torch.Tensor,     # (3, Ns)
    surf_mask: torch.Tensor,
    init_pose: Optional[se3.Pose] = None,
    reduce=None,                # cross-rank sum of (H, b, nc, ns): parallel.sharded_scan_to_map
) -> Scan2MapResult:
    if init_pose is None:
        init_pose = se3.identity(surf_pts.dtype, device=surf_pts.device)
    scfg = cfg.solver

    def search(pose):
        return (_corner_rows(cfg, corner_map, pose.apply(corner_pts), corner_mask),
                _surf_rows(cfg, surf_map, pose.apply(surf_pts), surf_mask))

    def linearize(pose, cache):
        Hc, bc, _, nc = _hb(pose.apply(corner_pts), cache[0])
        Hs, bs, _, ns = _hb(pose.apply(surf_pts), cache[1])
        out = (Hc + Hs, bc + bs, nc, ns)
        return reduce(out) if reduce is not None else out

    pose = init_pose
    done, iters = solver._start(init_pose)
    warmup = min(cfg.warmup_searches, scfg.max_iterations)
    n_rounds = -(-(scfg.max_iterations - warmup) // cfg.search_every)
    cache = None
    for chunk in [1] * warmup + [cfg.search_every] * max(n_rounds, 0):
        cache = search(pose)
        H0 = linearize(pose, cache)[0]
        proj = solver.degeneracy_projection(H0, cfg.degeneracy_eig)
        done = done | (iters >= scfg.max_iterations)
        for _ in range(chunk):
            H, b, _, _ = linearize(pose, cache)
            d = solver._solve_step(H, b, 0.0, proj)
            conv = solver._converged(d, scfg)
            pose = solver._select(done, pose, se3.retract_left(pose, d))
            iters = iters + (~done).to(torch.int32)
            done = done | conv
    if cache is None:  # max_iterations = 0: no correspondences
        def empty(n, dev):
            z = torch.zeros(n, dtype=surf_pts.dtype, device=dev)
            return (z, z, z, z, z, torch.zeros(n, dtype=torch.bool, device=dev))
        cache = (empty(corner_pts.shape[1], corner_pts.device), empty(surf_pts.shape[1], surf_pts.device))
    H, b, nc, ns = linearize(pose, cache)
    eigs = small_eigh.eigvalsh(H)
    return Scan2MapResult(pose, done, iters, nc, ns, H, eigs[0] < cfg.degeneracy_eig)
