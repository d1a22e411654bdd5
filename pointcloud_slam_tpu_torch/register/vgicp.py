"""Voxelized GICP (VGICP) and the (V)GICP source covariances (port of
`pointcloud_slam_tpu/register/vgicp.py`; `source_covariances_rbf` is not
ported yet).

Reference: fast_gicp `fast_vgicp.hpp` + `impl/fast_vgicp_impl.hpp` and the
CUDA core (`fast_vgicp_cuda.cu`, `compute_derivatives.cu`):
  - target = Gaussian voxel map (additive accumulation),
  - one correspondence per (source point, stencil offset) hit
    (fast_vgicp_impl.hpp:82-99, DIRECT1/7/27),
  - per-correspondence mahalanobis M = (C_voxel + T C_src T^T)^-1 and
    weight w = sqrt(voxel num_points) (fast_vgicp_impl.hpp:149-163),
  - source covariances from k-NN with PLANE regularization
    (fast_gicp_impl.hpp:241-298); method="exact" is the counterpart of the
    reference's GPU `brute_force_knn.cu` -> `covariance_estimation.cu` path
    and runs kernel K1 (`ops.bf_knn.knn`) on CUDA tensors.

The 6x6 normal equations are one contraction of the stacked Jacobian
columns (`_weighted_terms`) instead of the JAX package's 21 scalar
reductions: the sums run in another order.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Optional

import torch

from .. import ops
from ..geom import fit, se3
from ..ops import bf_knn
from ..ops import gaussian_grid as gg
from ..ops.voxel_grid import _stencil_tensor
from . import solver


@dataclasses.dataclass(frozen=True)
class VGICPConfig:
    resolution: float = 1.0
    k_correspondences: int = 8       # source covariance k-NN (ref default 20)
    min_points_per_voxel: int = 4
    nearby: int = 7                  # voxel_search_method DIRECT1/7/27
    search_every: int = 3
    solver: solver.SolverConfig = dataclasses.field(
        default_factory=lambda: solver.SolverConfig(max_iterations=35)
    )


class VGICPResult(NamedTuple):
    pose: se3.Pose
    converged: torch.Tensor
    iterations: torch.Tensor
    error: torch.Tensor
    H: torch.Tensor


def _plane_regularize(c00, c01, c02, c11, c12, c22, ok):
    """PLANE regularization: eigenvalues -> (1e-3, 1, 1) * lambda_max in the
    eigenbasis; degenerate points fall back to a small isotropic covariance.
    Returns (6, N)."""
    vals, vecs = fit.eigh3x3_soa(c00, c01, c02, c11, c12, c22)
    scale = torch.clamp(vals[2], min=1e-9)
    l = (1e-3 * scale, scale, scale)
    comps = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    out = [l[0] * vecs[0, i] * vecs[0, j] + l[1] * vecs[1, i] * vecs[1, j] + l[2] * vecs[2, i] * vecs[2, j]
           for (i, j) in comps]
    cov = torch.stack(out, dim=0)
    iso = torch.zeros_like(cov)
    for c in (0, 3, 5):
        iso[c].fill_(1e-2)
    return torch.where(ok[None, :], cov, iso)


def neighbor_covariances(nbrs: torch.Tensor, nmask: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """PLANE-regularized covariance of each point's masked neighbours.
    nbrs (3, k, N), nmask (k, N), cnt (N,) -> (6, N) [xx,xy,xz,yy,yz,zz]."""
    m = nmask.to(nbrs.dtype)
    n = torch.clamp(torch.sum(m, dim=0), min=1.0)
    mx = torch.sum(nbrs[0] * m, dim=0) / n
    my = torch.sum(nbrs[1] * m, dim=0) / n
    mz = torch.sum(nbrs[2] * m, dim=0) / n
    dx = (nbrs[0] - mx[None]) * m
    dy = (nbrs[1] - my[None]) * m
    dz = (nbrs[2] - mz[None]) * m
    c00 = torch.sum(dx * dx, dim=0) / n
    c01 = torch.sum(dx * dy, dim=0) / n
    c02 = torch.sum(dx * dz, dim=0) / n
    c11 = torch.sum(dy * dy, dim=0) / n
    c12 = torch.sum(dy * dz, dim=0) / n
    c22 = torch.sum(dz * dz, dim=0) / n
    return _plane_regularize(c00, c01, c02, c11, c12, c22, cnt >= 3)


def exact_neighbors(points: torch.Tensor, mask: torch.Tensor, k: int, knn_fn=bf_knn.knn):
    """Exact k-NN of every point among the masked points (masked points are
    moved far away, pad_cloud's convention). Returns (nbrs (3, k, N),
    nmask (k, N), cnt (N,))."""
    db = bf_knn.pad_cloud(points, mask, 1)
    d2, idx = knn_fn(db, db, k=k)
    nbrs = db[:, idx.long()]                      # (3, k, N)
    nmask = d2 < 1.0e30                           # masked neighbors are far
    cnt = torch.sum(nmask, dim=0).to(torch.int32)
    return nbrs, nmask, cnt


def source_covariances(points: torch.Tensor, mask: torch.Tensor, k: int = 8, resolution: float = 1.0,
                       method: str = "voxel"):
    """Per-point PLANE-regularized covariances from k-NN within the cloud
    (fast_gicp calculate_covariances). Returns (6, N) [xx,xy,xz,yy,yz,zz].

    method="voxel": approximate k-NN over a stencil-7 voxel grid (bounded
    radius 2*resolution).
    method="exact": exact brute-force k-NN, kernel K1 (unbounded radius,
    exactly k neighbors — the kd-tree/CUDA semantics of the reference)."""
    if method == "exact":
        nbrs, nmask, cnt = exact_neighbors(points, mask, k)
    elif method == "voxel":
        cfg = ops.GridConfig(
            capacity=max(1 << 14, 1 << (int(points.shape[1]).bit_length())),
            pts_per_voxel=8,
            resolution=resolution,
            nearby=7,
        )
        grid = ops.insert(cfg, ops.create(cfg, points.dtype, device=points.device), points, mask)
        nbrs, d2, cnt, _ = ops.knn(cfg, grid, points, k=k, max_range=2.0 * resolution)
        nmask = torch.arange(k, device=points.device)[:, None] < cnt[None, :]
    else:
        raise ValueError(f"unknown covariance method {method!r}")
    return neighbor_covariances(nbrs, nmask, cnt)


def _check_bake_coverage(baked_map: gg.BakedGaussianMap, baked_cfg: ops.GridConfig):
    """Warn when the bake dropped (voxel, offset) entries for lack of
    capacity: baked correspondences would then miss neighbours. The one host
    read of a target build (the JAX package's `ndt._check_bake_coverage`)."""
    dropped = int(baked_map.dropped)
    if dropped > 0:
        warnings.warn(
            f"gg.bake dropped {dropped} stencil entries (baked capacity "
            f"{baked_cfg.capacity} too small for this map x nearby={baked_cfg.nearby}); "
            "baked correspondences will MISS neighbors — raise baked_capacity",
            stacklevel=3,
        )


def build_target(cfg: VGICPConfig, target: torch.Tensor, mask: Optional[torch.Tensor] = None,
                 capacity: int = 1 << 16, baked: bool = False, baked_capacity: Optional[int] = None):
    """Target Gaussian voxel map on the target's device. baked=True expands
    it with gg.bake, so each search is one probe and one wide gather instead
    of `nearby` probes and gathers — identical results."""
    if mask is None:
        mask = torch.ones(target.shape[1], dtype=torch.bool, device=target.device)
    grid_cfg = ops.GridConfig(capacity=capacity, resolution=cfg.resolution, nearby=cfg.nearby)
    g = gg.build(grid_cfg, target, mask, mode="plane", min_points=cfg.min_points_per_voxel)
    if not baked:
        return grid_cfg, g
    baked_cfg = ops.GridConfig(capacity=baked_capacity or 4 * capacity, resolution=cfg.resolution,
                               nearby=cfg.nearby)
    baked_map = gg.bake(grid_cfg, g, baked_cfg)
    _check_bake_coverage(baked_map, baked_cfg)
    return baked_cfg, baked_map


def _sym_inv3(a00, a01, a02, a11, a12, a22):
    """Closed-form inverse of symmetric 3x3 component arrays."""
    i00 = a11 * a22 - a12 * a12
    i01 = a02 * a12 - a01 * a22
    i02 = a01 * a12 - a02 * a11
    i11 = a00 * a22 - a02 * a02
    i12 = a01 * a02 - a00 * a12
    i22 = a00 * a11 - a01 * a01
    det = a00 * i00 + a01 * i01 + a02 * i02
    inv = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    return i00 * inv, i01 * inv, i02 * inv, i11 * inv, i12 * inv, i22 * inv


def _src_cov_world(src_cov, R):
    """T C_src T^T per point (6 components)."""
    s00, s01, s02, s11, s12, s22 = (src_cov[c] for c in range(6))
    rc = [[R[i, 0] * [s00, s01, s02][j] + R[i, 1] * [s01, s11, s12][j] + R[i, 2] * [s02, s12, s22][j]
           for j in range(3)] for i in range(3)]
    t00 = rc[0][0] * R[0, 0] + rc[0][1] * R[0, 1] + rc[0][2] * R[0, 2]
    t01 = rc[0][0] * R[1, 0] + rc[0][1] * R[1, 1] + rc[0][2] * R[1, 2]
    t02 = rc[0][0] * R[2, 0] + rc[0][1] * R[2, 1] + rc[0][2] * R[2, 2]
    t11 = rc[1][0] * R[1, 0] + rc[1][1] * R[1, 1] + rc[1][2] * R[1, 2]
    t12 = rc[1][0] * R[2, 0] + rc[1][1] * R[2, 1] + rc[1][2] * R[2, 2]
    t22 = rc[2][0] * R[2, 0] + rc[2][1] * R[2, 1] + rc[2][2] * R[2, 2]
    return t00, t01, t02, t11, t12, t22


def _weighted_terms(w, p, q, m):
    """(H (6, 6), b (6,), err ()) of sum w q^T M q over correspondences, with
    dq/d[omega, v] = [-hat(p) | I]. w (...), p and q (3, ...) world point and
    residual, m the six components of M (...); all broadcast to one shape.
    The six Jacobian columns are stacked and reduced with one contraction;
    H is symmetrized."""
    m00, m01, m02, m11, m12, m22 = m
    M = torch.stack([torch.stack([m00, m01, m02]), torch.stack([m01, m11, m12]), torch.stack([m02, m12, m22])])
    shape = M.shape[2:]
    p = p.expand((3,) + shape)
    r = torch.einsum("ab...,b...->a...", M, q)                      # M q
    err = torch.sum(w * torch.sum(q * r, dim=0))
    zero, one = torch.zeros_like(p[0]), torch.ones_like(p[0])
    px, py, pz = p[0], p[1], p[2]
    J = torch.stack([torch.stack([zero, pz, -py, one, zero, zero]),
                     torch.stack([-pz, zero, px, zero, one, zero]),
                     torch.stack([py, -px, zero, zero, zero, one])])  # (3, 6, ...)
    wJ = (J * w).reshape(3, 6, -1)
    MJ = torch.einsum("ab...,bi...->ai...", M, J).reshape(3, 6, -1)
    H = torch.einsum("aip,ajp->ij", wJ, MJ)
    b = torch.einsum("aip,ap->i", wJ, r.reshape(3, -1))
    return 0.5 * (H + H.T), b, err


def _offset_terms(pw, ok, cnt, mean, cov6, t6):
    """The weighted mahalanobis H/b/err of a cached correspondence set:
    pw (3, N) world points, ok/cnt (S, N), mean (3, S, N), cov6 (6, S, N)
    voxel statistics, t6 the source covariances in the world (six (N,))."""
    w = torch.where(ok, torch.sqrt(torch.clamp(cnt, min=1.0)), 0.0)
    p = pw[:, None, :]
    m = _sym_inv3(*(cov6[c] + t6[c] for c in range(6)))          # M = (C_voxel + T C_src T^T)^-1
    return _weighted_terms(w, p, p - mean, m)


def _vgicp_search(cfg: VGICPConfig, grid_cfg, target, source, source_mask, packed, pose):
    """Voxel correspondences at `pose`: ok (S, N), cnt (S, N), mean (3, S, N),
    cov (6, S, N), one per (source point, stencil offset)."""
    coords = ops.point_to_voxel(pose.apply(source), cfg.resolution)
    if packed is not None:
        ent, found = gg.baked_probe(grid_cfg, target, coords, packed)
        ok = (ent[:, 0] > 0.5) & found[None, :] & source_mask[None, :]
        return ok, ent[:, 1], ent[:, 2:5].transpose(0, 1), ent[:, 5:11].transpose(0, 1)
    cc = coords[:, None, :] + _stencil_tensor(cfg.nearby, coords.device)[:, :, None]   # (3, S, N)
    S, N = cc.shape[1], cc.shape[2]
    slot = gg.probe(grid_cfg, target, (cc[0].reshape(-1), cc[1].reshape(-1), cc[2].reshape(-1))).reshape(S, N)
    safe = torch.clamp(slot, min=0)
    ok = (slot >= 0) & target.valid[safe] & source_mask[None, :]
    return ok, target.count[safe], target.mean[:, safe], target.cov[:, safe]


def align(
    grid_cfg: ops.GridConfig,
    target,
    source: torch.Tensor,
    source_cov: torch.Tensor,
    source_mask: Optional[torch.Tensor] = None,
    init_pose: Optional[se3.Pose] = None,
    cfg: VGICPConfig = VGICPConfig(),
) -> VGICPResult:
    """Align source (3, N) with per-point covariances (6, N) to the voxel map
    (a GaussianVoxelMap, or a BakedGaussianMap with its baked config).

    Cached-search rounds: the voxel correspondences are searched once per
    `search_every` iterations (a static schedule: plain Python loops, no
    host read) and their statistics cached; between searches each GN
    iteration recomputes the exact mahalanobis terms at the fresh pose."""
    if source_mask is None:
        source_mask = torch.ones(source.shape[1], dtype=torch.bool, device=source.device)
    if init_pose is None:
        init_pose = se3.identity(source.dtype, device=source.device)
    scfg = cfg.solver
    packed = None
    if isinstance(target, gg.BakedGaussianMap):
        packed = torch.cat([target.entries[:, 0:1], target.counts[:, None, :],
                            target.entries[:, 1:4], target.covs], dim=1)       # (S, 11, C)

    def terms(pose, cache):
        ok, cnt, mean, cov = cache
        return _offset_terms(pose.apply(source), ok, cnt, mean, cov, _src_cov_world(source_cov, pose.R))

    pose = init_pose
    done, iters = solver._start(init_pose)
    every = max(1, cfg.search_every)
    cache = None
    for _ in range(-(-scfg.max_iterations // every)):
        cache = _vgicp_search(cfg, grid_cfg, target, source, source_mask, packed, pose)
        done = done | (iters >= scfg.max_iterations)
        for _ in range(every):
            H, b, _ = terms(pose, cache)
            pose, done, iters, _ = solver._gn_update(H, b, pose, done, iters, scfg,
                                                     lam=1e-6 * H.diagonal().abs().amax())
    if cache is None:  # max_iterations = 0: no correspondences, zero terms
        z = source.new_zeros(())
        return VGICPResult(pose, done, iters, z, source.new_zeros((6, 6)))
    # final terms at the converged pose (error + Hessian report)
    H, _, err = terms(pose, cache)
    return VGICPResult(pose, done, iters, err, H)
