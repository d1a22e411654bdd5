"""Point-level Generalized-ICP (distribution-to-distribution, single NN)
(port of `pointcloud_slam_tpu/register/gicp.py`).

Reference: fast_gicp `fast_gicp.hpp` + `impl/fast_gicp_impl.hpp`:
  - per-point covariances from k-NN with PLANE regularization on BOTH clouds
    (`calculate_covariances` :241-298),
  - single nearest-neighbour correspondences with a max-distance gate
    (`update_correspondences` :115-152),
  - per-pair mahalanobis (C_tgt + T C_src T^T)^-1 in the weighted GN
    linearization (`linearize` :155-211).

The target's per-point covariances live in a flat attribute array parallel
to the voxel map's point blocks, joined through the k-NN's flat indices.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .. import ops
from ..geom import se3
from ..ops.voxel_grid import _scatter_drop
from . import solver
from .vgicp import _src_cov_world, _sym_inv3, _weighted_terms, source_covariances


@dataclasses.dataclass(frozen=True)
class GICPConfig:
    k_correspondences: int = 8        # ref default 20; 8 covers planar scenes
    max_corr_dist: float = 2.0        # correspondence gate
    cov_resolution: float = 1.0       # k-NN grid resolution for covariances
    cov_method: str = "voxel"         # "voxel" (approx) | "exact" (brute force, kernel K1)
    search_every: int = 2
    solver: solver.SolverConfig = dataclasses.field(
        default_factory=lambda: solver.SolverConfig(max_iterations=40)
    )


class GICPResult(NamedTuple):
    pose: se3.Pose
    converged: torch.Tensor
    iterations: torch.Tensor
    error: torch.Tensor
    H: torch.Tensor


def build_target(cfg: GICPConfig, target: torch.Tensor, mask: Optional[torch.Tensor] = None,
                 capacity: int = 1 << 15):
    """Voxel map of the target + flat per-point covariance attribute array
    (6, K*C), on the target's device. cov_method="exact" runs K1 on CUDA."""
    if mask is None:
        mask = torch.ones(target.shape[1], dtype=torch.bool, device=target.device)
    grid_cfg = ops.GridConfig(capacity=capacity, pts_per_voxel=8, resolution=cfg.cov_resolution, nearby=7)
    grid, flat_idx = ops.insert(grid_cfg, ops.create(grid_cfg, target.dtype, device=target.device), target, mask,
                                return_indices=True)
    covs = source_covariances(target, mask, k=cfg.k_correspondences, resolution=cfg.cov_resolution,
                              method=cfg.cov_method)
    KC = grid_cfg.capacity * grid_cfg.pts_per_voxel
    att = torch.zeros((6, KC), dtype=target.dtype, device=target.device)
    att = _scatter_drop(att, torch.where(flat_idx >= 0, flat_idx, KC), covs, KC)
    return grid_cfg, grid, att


def _search(cfg: GICPConfig, grid_cfg, grid, pw, mask):
    """Nearest map point within max_corr_dist: (nn (3, N), flat index (N,), ok (N,))."""
    nbrs, _, cnt, idx = ops.knn(grid_cfg, grid, pw, k=1, max_range=cfg.max_corr_dist)
    return nbrs[:, 0, :], torch.clamp(idx[0], min=0).to(torch.int64), (cnt > 0) & mask


def _linearize(tgt_cov_flat, src, src_cov, pose, cache):
    """(H, b, err) at `pose` against the cached correspondences."""
    nn, nn_idx, ok = cache
    pw = pose.apply(src)
    t6 = _src_cov_world(src_cov, pose.R)
    m = _sym_inv3(*(tgt_cov_flat[c, nn_idx] + t6[c] for c in range(6)))
    return _weighted_terms(ok.to(src.dtype), pw, pw - nn, m)


def align(
    grid_cfg: ops.GridConfig,
    grid: ops.VoxelHashMap,
    target_cov_flat: torch.Tensor,
    source: torch.Tensor,
    source_cov: torch.Tensor,
    source_mask: Optional[torch.Tensor] = None,
    init_pose: Optional[se3.Pose] = None,
    cfg: GICPConfig = GICPConfig(),
) -> GICPResult:
    """Align source (3, N) with covariances (6, N) to a `build_target` target.

    The JAX package re-searches under `lax.cond` when the iteration is a
    multiple of `search_every` or the last step was big, and the pose is
    not done. Reading that flag on the host would sync every iteration, so
    the search runs on every one of the `max_iterations` iterations here and
    `torch.where` keeps the cached correspondences where it was not due: the
    same result with no host read. The cost grows once the pose is done,
    where JAX stops searching: a solve that converges after a few of its 40
    iterations searches 40 times here against a handful in JAX."""
    if source_mask is None:
        source_mask = torch.ones(source.shape[1], dtype=torch.bool, device=source.device)
    if init_pose is None:
        init_pose = se3.identity(source.dtype, device=source.device)
    scfg = cfg.solver
    N, dev = source.shape[1], source.device
    pose = init_pose
    done, iters = solver._start(init_pose)
    big = torch.zeros((), dtype=torch.bool, device=dev)
    cache = (torch.zeros((3, N), dtype=source.dtype, device=dev), torch.zeros((N,), dtype=torch.int64, device=dev),
             torch.zeros((N,), dtype=torch.bool, device=dev))
    for it in range(scfg.max_iterations):
        due = (big | (it % cfg.search_every == 0)) & ~done
        fresh = _search(cfg, grid_cfg, grid, pose.apply(source), source_mask)
        cache = tuple(torch.where(due, f, c) for f, c in zip(fresh, cache))
        H, b, _ = _linearize(target_cov_flat, source, source_cov, pose, cache)
        pose, done, iters, d = solver._gn_update(H, b, pose, done, iters, scfg, lam=1e-6 * H.diagonal().abs().amax())
        big = (d[:3].abs().amax() > 0.02) | (d[3:].abs().amax() > 0.05)
    H, _, err = _linearize(target_cov_flat, source, source_cov, pose, cache)
    return GICPResult(pose, done, iters, err, H)
