"""Prior-map NDT localization with its fitness gate: the benchmark's plain
reference. A frozen copy of the NDT path of
`pointcloud_slam_tpu_torch/models/localization/pipeline.py` at commit
9c22c1c (`localize_ndt`, `_gate`, `relocalize`), with the point map and the
fitness score of `register/icp.py` (`build_target_map`, `fitness_score`).

Reference: `src/jueying_slam/src/localization.cpp` / `new_localization.cpp`
fitness gating + lose flag (`laserCloudInfoHandler` :424-476,
`my_getFitnessScore` :342-375).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from . import ndt, se3, solver
from . import voxel_grid as ops


@dataclasses.dataclass(frozen=True)
class LocalizationConfig:
    fitness_thresh: float = 0.15     # Corner_fitness gate (localization.cpp:424)
    fitness_range: float = 1.0
    ndt: ndt.NDTConfig = dataclasses.field(default_factory=lambda: ndt.NDTConfig(resolution=1.0))
    # the raw-point map the fitness score reads (the app builds it on
    # Scan2MapConfig's surf_grid)
    point_grid: ops.GridConfig = dataclasses.field(
        default_factory=lambda: ops.GridConfig(capacity=1 << 16, pts_per_voxel=8, resolution=0.8, nearby=7))
    min_matched_frac: float = 0.3
    degeneracy_eigen_thresh: float = 10.0


class LocalizationResult(NamedTuple):
    pose: se3.Pose
    fitness: torch.Tensor
    matched_frac: torch.Tensor
    lost: torch.Tensor
    degenerate: torch.Tensor
    max_eigen: torch.Tensor


def build_target_map(grid_cfg: ops.GridConfig, target: torch.Tensor) -> ops.VoxelHashMap:
    """The raw-point map of a prior cloud (3, N)."""
    grid = ops.create(grid_cfg, dtype=target.dtype, device=target.device)
    return ops.insert(grid_cfg, grid, target, torch.ones(target.shape[1], dtype=torch.bool, device=target.device))


def fitness_score(grid_cfg: ops.GridConfig, grid: ops.VoxelHashMap, source_world: torch.Tensor,
                  mask: torch.Tensor, max_range: float = 1.0):
    """Mean squared NN distance of matched points (pcl::Registration::
    getFitnessScore semantics). Returns (score, n_matched) as tensors."""
    _, d2, cnt, _ = ops.knn(grid_cfg, grid, source_world, k=1, max_range=max_range)
    matched = (cnt > 0) & mask
    d = torch.where(matched, d2[0, :], 0.0)
    n = torch.clamp(torch.sum(matched), min=1)
    return torch.sum(d) / n, torch.sum(matched)


def _gate(cfg: LocalizationConfig, grid_cfg: ops.GridConfig, point_map: ops.VoxelHashMap, pw, mask):
    """(fitness, matched fraction, lost) of the world-frame points against the map."""
    fitness, n_matched = fitness_score(grid_cfg, point_map, pw, mask, max_range=cfg.fitness_range)
    frac = n_matched.to(pw.dtype) / torch.clamp(torch.sum(mask), min=1).to(pw.dtype)
    return fitness, frac, (fitness > cfg.fitness_thresh) | (frac < cfg.min_matched_frac)


def localize_ndt(cfg: LocalizationConfig, ndt_grid_cfg: ops.GridConfig, ndt_map, point_map: ops.VoxelHashMap,
                 pts: torch.Tensor, mask: torch.Tensor, init_pose: se3.Pose) -> LocalizationResult:
    res = ndt.align(ndt_grid_cfg, ndt_map, pts, mask, init_pose, cfg=cfg.ndt)
    pw = res.pose.apply(pts)
    fitness, frac, lost = _gate(cfg, cfg.point_grid, point_map, pw, mask)
    return LocalizationResult(res.pose, fitness, frac, lost, res.max_eigen < cfg.degeneracy_eigen_thresh,
                              res.max_eigen)


def relocalize(result: LocalizationResult, fallback_pose: se3.Pose) -> se3.Pose:
    """On loss, restart matching from the externally provided initial pose."""
    return solver._select(result.lost, fallback_pose, result.pose)
