"""Prior-map localization: scan-to-tile-map matching with loss detection
(port of `pointcloud_slam_tpu/models/localization/pipeline.py`).

Reference: `src/jueying_slam/src/localization.cpp` / `new_localization.cpp`
  - dynamic area-tile map loading around the pose (`dynamic_load_map_run`
    :281-315 + dynamic_map.h): host side, `io.pcd.tiles_for_position` feeds
    re-built device maps (`apps/run_localization_torch.py`),
  - matching method switch "loam" | "ndt" (`Matching_method`),
  - fitness gating + relocalization + lose flag (`laserCloudInfoHandler`
    :424-476, `my_getFitnessScore` :342-375),
  - the status channel: fitness scores exported like odometry
    covariance[0:2] (localization.cpp:1243-1244).

Every field of a result stays on the device: `localize_loam`,
`localize_ndt` and `relocalize` read nothing back to the host (scan-to-map's
and NDT's eigendecompositions are kernel K6, `ops.small_eigh`, on the card).
`localize_ndt` is a root span (`utils/timer.Timer`) around `ndt.align`'s
spans and `localize_ndt.gate`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ... import ops, register
from ...geom import se3
from ...register import solver
from ...utils.timer import Timer
from ..liosam import scan2map as s2m


@dataclasses.dataclass(frozen=True)
class LocalizationConfig:
    method: str = "loam"             # "loam" | "ndt" (Matching_method)
    fitness_thresh: float = 0.15     # Corner_fitness gate (localization.cpp:424)
    fitness_range: float = 1.0
    ndt: register.NDTConfig = dataclasses.field(default_factory=lambda: register.NDTConfig(resolution=1.0))
    # degeneracy_eig=1.0, not the SLAM local-map default 100: the prior map
    # is voxel-capped (<= 8 points a voxel), so scan-to-map Hessian
    # eigenvalues sit far below the reference's raw threshold; at 100 the
    # degeneracy projection clamps ~2 cm of every update and sequential
    # localization lags into divergence (the JAX package measured 0.027 ->
    # 0.32 m over 16 frames of bench config 8 at 100, ~0.02 m at 1.0)
    scan2map: s2m.Scan2MapConfig = dataclasses.field(
        default_factory=lambda: s2m.Scan2MapConfig(degeneracy_eig=1.0))
    # minimum matched-point fraction before declaring loss (the reference's
    # effective-point gate in laserCloudInfoHandler :424-476)
    min_matched_frac: float = 0.3
    # NDT degeneracy flag threshold on the max Hessian eigenvalue; the raw
    # value is also exported in `max_eigen` for an external judge, as the
    # reference publishes getMaxEigen (ndt_omp.h:209-223)
    degeneracy_eigen_thresh: float = 10.0


class LocalizationResult(NamedTuple):
    pose: se3.Pose
    fitness: torch.Tensor       # mean-squared NN distance (status channel)
    matched_frac: torch.Tensor
    lost: torch.Tensor          # fitness gate failed -> relocalize needed
    degenerate: torch.Tensor
    max_eigen: torch.Tensor     # raw NDT Hessian max eigenvalue (0 for LOAM)


def _gate(cfg: LocalizationConfig, grid_cfg: ops.GridConfig, point_map: ops.VoxelHashMap, pw, mask):
    """(fitness, matched fraction, lost) of the world-frame points against the map."""
    fitness, n_matched = register.fitness_score(grid_cfg, point_map, pw, mask, max_range=cfg.fitness_range)
    frac = n_matched.to(pw.dtype) / torch.clamp(torch.sum(mask), min=1).to(pw.dtype)
    return fitness, frac, (fitness > cfg.fitness_thresh) | (frac < cfg.min_matched_frac)


def localize_loam(
    cfg: LocalizationConfig,
    grid_cfg,  # unused, kept for the JAX package's signature
    corner_map: ops.VoxelHashMap,
    surf_map: ops.VoxelHashMap,
    corner_pts: torch.Tensor,
    corner_mask: torch.Tensor,
    surf_pts: torch.Tensor,
    surf_mask: torch.Tensor,
    init_pose: se3.Pose,
) -> LocalizationResult:
    res = s2m.scan_to_map(cfg.scan2map, corner_map, surf_map, corner_pts, corner_mask, surf_pts, surf_mask,
                          init_pose)
    pw = res.pose.apply(surf_pts)
    fitness, frac, lost = _gate(cfg, cfg.scan2map.surf_grid, surf_map, pw, surf_mask)
    return LocalizationResult(res.pose, fitness, frac, lost, res.degenerate, pw.new_zeros(()))


def localize_ndt(
    cfg: LocalizationConfig,
    ndt_grid_cfg: ops.GridConfig,
    ndt_map,                          # GaussianVoxelMap or BakedGaussianMap
    point_grid_cfg: ops.GridConfig,
    point_map: ops.VoxelHashMap,      # raw-point map for the fitness score
    pts: torch.Tensor,
    mask: torch.Tensor,
    init_pose: se3.Pose,
) -> LocalizationResult:
    with Timer.span("localize_ndt"):
        res = register.ndt.align(ndt_grid_cfg, ndt_map, pts, mask, init_pose, cfg=cfg.ndt)
        with Timer.span("localize_ndt.gate"):
            pw = res.pose.apply(pts)
            fitness, frac, lost = _gate(cfg, point_grid_cfg, point_map, pw, mask)
        return LocalizationResult(res.pose, fitness, frac, lost, res.max_eigen < cfg.degeneracy_eigen_thresh,
                                  res.max_eigen)


def relocalize(result: LocalizationResult, fallback_pose: se3.Pose) -> se3.Pose:
    """On loss, restart matching from the externally provided initial pose
    (localization.cpp relocalization from initialPose); no host read."""
    return solver._select(result.lost, fallback_pose, result.pose)
