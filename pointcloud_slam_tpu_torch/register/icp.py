"""Point-to-plane ICP against a voxel-hash map (port of
`pointcloud_slam_tpu/register/icp.py`).

Reference: `laser_mapping.cc:592-701` (ObsModel: 5-NN in iVox ->
esti_plane -> point-to-plane residual + Jacobian rows) driving a standalone
scan-to-map ICP, and fast_gicp's `lsq_registration_impl.hpp` for the
solver loop.

Each GN iteration is (stencil k-NN) -> (batched plane fit) -> (residual and
Jacobian as one (6, N) block) -> (H = J J^T) -> (6x6 solve). The search
schedule is static (`_round_counts`), so the solve is a fixed sequence of
launches with no host read; `done` masks freeze converged poses.

Two workarounds of the JAX package are not ported: the
`optimization_barrier` in `correspondences` and the reroute of baked
single-frame solves through the batched solver. Both dodge a libtpu
miscompile; here the baked single-frame path solves directly.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .. import ops
from ..geom import fit, se3, so3
from . import solver


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    num_neighbors: int = 5
    min_neighbors: int = 3          # options::MIN_NUM_MATCH_POINTS
    max_corr_dist: float = 5.0      # kNN range gate
    plane_threshold: float = 0.1    # options::ESTI_PLANE_THRESHOLD
    # re-run the kNN + plane-fit search every this many GN iterations and
    # reuse the cached planes in between (laser_mapping.cc:618)
    search_every: int = 5
    # the first `warmup_searches` rounds are one iteration long
    warmup_searches: int = 2
    solver: solver.SolverConfig = dataclasses.field(default_factory=lambda: solver.SolverConfig())


class ICPResult(NamedTuple):
    pose: se3.Pose
    converged: torch.Tensor
    iterations: torch.Tensor
    final_error: torch.Tensor
    num_inliers: torch.Tensor
    H: torch.Tensor  # (6, 6) information matrix export (degeneracy judge)


def correspondences(cfg: ICPConfig, grid_cfg: ops.GridConfig, grid: ops.VoxelHashMap,
                    pts_world: torch.Tensor, mask: torch.Tensor):
    """k-NN + plane fit for each world-frame point. pts_world is (3, N).
    Returns (coef (4, N) plane [n, d], valid (N,))."""
    nbrs, d2, cnt, _ = ops.knn(grid_cfg, grid, pts_world, k=cfg.num_neighbors, max_range=cfg.max_corr_dist)
    nmask = torch.arange(d2.shape[0], device=d2.device)[:, None] < cnt[None, :]
    coef, plane_ok = fit.plane_fit(nbrs, nmask, threshold=cfg.plane_threshold, min_pts=cfg.min_neighbors)
    valid = mask & plane_ok & (cnt >= cfg.min_neighbors)
    return coef, valid


def _residual_rows(coef, valid, pw):
    """Point-to-plane Jacobian rows J (6, N) and residuals r (N,) at world
    points pw (3, N) against cached planes. Selects with `where` (not a
    multiply): invalid fits may hold non-finite values."""
    nx = torch.where(valid, coef[0], 0.0)
    ny = torch.where(valid, coef[1], 0.0)
    nz = torch.where(valid, coef[2], 0.0)
    r = torch.where(valid, pw[0] * nx + pw[1] * ny + pw[2] * nz + coef[3], 0.0)
    # left-multiplicative tangent: dr/d[omega, v] = [(pw x n), n]
    cx = pw[1] * nz - pw[2] * ny
    cy = pw[2] * nx - pw[0] * nz
    cz = pw[0] * ny - pw[1] * nx
    return torch.stack([cx, cy, cz, nx, ny, nz], dim=0), r


def _linearize_cached(coef, valid, pw, batch: int = 0):
    """Residual/Jacobian against cached plane coefficients at world points pw.
    pw (3, N) -> (H (6, 6), b (6,), err ()); with `batch` = B, pw is B frames
    flattened frame-major (3, B*N) -> (H (B, 6, 6), b (B, 6), err (B,))."""
    J, r = _residual_rows(coef, valid, pw)
    if not batch:
        return J @ J.T, J @ r, torch.sum(r * r)
    J, r = J.reshape(6, batch, -1), r.reshape(batch, -1)
    return torch.einsum("ibn,jbn->bij", J, J), torch.einsum("ibn,bn->bi", J, r), torch.sum(r * r, dim=1)


def _linearize(cfg, grid_cfg, grid, src, mask, pose):
    """src (3, N) in sensor frame. Returns (H (6,6), b (6,), err, n_inliers)."""
    pw = pose.apply(src)
    coef, valid = correspondences(cfg, grid_cfg, grid, pw, mask)
    H, b, err = _linearize_cached(coef, valid, pw)
    return H, b, err, torch.sum(valid)


def _round_counts(cfg: ICPConfig, total: int):
    """Static search schedule: `warmup_searches` one-iteration rounds first,
    then ceil of the rest in `search_every`-iteration rounds. Iterations
    beyond solver.max_iterations are frozen via the `done` gate."""
    warmup = min(cfg.warmup_searches, total)
    rest = total - warmup
    n_rounds = -(-rest // cfg.search_every) if rest > 0 else 0
    return warmup, n_rounds


def _flat(pw: torch.Tensor) -> torch.Tensor:
    """World points (3, N) or (B, 3, N) -> (3, N) or frame-major (3, B*N)."""
    return pw if pw.dim() == 2 else pw.transpose(0, 1).reshape(3, -1)


def icp_loop(cfg: ICPConfig, source: torch.Tensor, init_pose: se3.Pose, search, reduce=None):
    """The cached-search GN iteration. `search(pose) -> (coef (4, N), valid
    (N,))` produces plane correspondences at a pose. `source` is (3, N) with
    an unbatched pose, or (B, 3, N) with a pose of batch B (the batched
    solver: correspondences flattened frame-major to (4, B*N), one 6x6 system
    per frame). One search per round, then the round's GN iterations against
    the cached planes. Returns (pose, done, iters, H, coef, valid).

    `reduce`, when given, combines (H, b, err) across the ranks that hold
    the other point shards of the same frames (`parallel.
    sharded_point_to_plane_icp`), so every rank applies the same update."""
    scfg = cfg.solver
    batch = source.shape[0] if source.dim() == 3 else 0
    n = source.shape[-1] * max(batch, 1)
    pose = init_pose
    done, iters = solver._start(init_pose)
    H = torch.zeros(init_pose.t.shape[:-1] + (6, 6), dtype=source.dtype, device=source.device)
    coef = torch.zeros((4, n), dtype=source.dtype, device=source.device)
    valid = torch.zeros((n,), dtype=torch.bool, device=source.device)
    warmup, n_rounds = _round_counts(cfg, scfg.max_iterations)
    for chunk in [1] * warmup + [cfg.search_every] * n_rounds:
        coef, valid = search(pose)
        done = done | (iters >= scfg.max_iterations)
        for _ in range(chunk):
            H, b, err = _linearize_cached(coef, valid, _flat(pose.apply(source)), batch)
            if reduce is not None:
                H, b, err = reduce((H, b, err))
            pose, done, iters, _ = solver._gn_update(H, b, pose, done, iters, scfg)
    return pose, done, iters, H, coef, valid


def point_to_plane_icp(
    grid_cfg: ops.GridConfig,
    grid: ops.VoxelHashMap,
    source: torch.Tensor,
    source_mask: Optional[torch.Tensor] = None,
    init_pose: Optional[se3.Pose] = None,
    cfg: ICPConfig = ICPConfig(),
) -> ICPResult:
    """Align `source` (3, N) to the map. Returns the world<-source pose."""
    if source_mask is None:
        source_mask = torch.ones(source.shape[1], dtype=torch.bool, device=source.device)
    if init_pose is None:
        init_pose = se3.identity(source.dtype, device=source.device)

    def search(pose):
        return correspondences(cfg, grid_cfg, grid, pose.apply(source), source_mask)

    pose, done, iters, H, coef, valid = icp_loop(cfg, source, init_pose, search)
    # final stats from the last cached correspondences re-evaluated at the
    # converged pose (the reference reports the last iteration's counts)
    _, _, err = _linearize_cached(coef, valid, pose.apply(source))
    return ICPResult(pose, done, iters, err, torch.sum(valid), H)


def batched_point_to_plane_icp(
    grid_cfg: ops.GridConfig,
    grid: ops.VoxelHashMap,
    sources: torch.Tensor,                       # (B, 3, N): B frames, one shared map
    source_mask: Optional[torch.Tensor] = None,  # (B, N)
    init_R: Optional[torch.Tensor] = None,       # (B, 3, 3)
    init_t: Optional[torch.Tensor] = None,       # (B, 3)
    cfg: ICPConfig = ICPConfig(),
    return_stats: bool = False,
):
    """Throughput-mode ICP: B frames solved together. The point axes of all
    frames are flattened into one (3, B*N) query set, so every k-NN search
    is one pass; H/b reduce per frame. The search schedule is shared across
    the batch. Returns (pose, done, iters), plus (err, inliers, H) per frame
    re-evaluated at the final poses with `return_stats`."""
    B, _, N = sources.shape
    dtype, dev = sources.dtype, sources.device
    if source_mask is None:
        source_mask = torch.ones((B, N), dtype=torch.bool, device=dev)
    if init_R is None:
        init_R = torch.eye(3, dtype=dtype, device=dev).expand(B, 3, 3)
    if init_t is None:
        init_t = torch.zeros((B, 3), dtype=dtype, device=dev)
    mask_flat = source_mask.reshape(B * N)

    def search(pose):
        return correspondences(cfg, grid_cfg, grid, _flat(pose.apply(sources)), mask_flat)

    pose, done, iters, _, coef, valid = icp_loop(cfg, sources, se3.Pose(init_R, init_t), search)
    if not return_stats:
        return pose, done, iters
    H, _, err = _linearize_cached(coef, valid, _flat(pose.apply(sources)), B)
    return pose, done, iters, (err, torch.sum(valid.reshape(B, N), dim=1), H)


def so3_exp_batched(w: torch.Tensor) -> torch.Tensor:
    """(B, 3) -> (B, 3, 3); thin alias over geom.so3.exp (already batched)."""
    return so3.exp(w)


def build_target_map(target: torch.Tensor, mask: Optional[torch.Tensor] = None,
                     grid_cfg: Optional[ops.GridConfig] = None) -> tuple:
    """Convenience: drop a target cloud (3, N) into a fresh voxel map on the
    target's device."""
    if grid_cfg is None:
        grid_cfg = ops.GridConfig()
    if mask is None:
        mask = torch.ones(target.shape[1], dtype=torch.bool, device=target.device)
    grid = ops.create(grid_cfg, dtype=target.dtype, device=target.device)
    return grid_cfg, ops.insert(grid_cfg, grid, target, mask)


def fitness_score(grid_cfg: ops.GridConfig, grid: ops.VoxelHashMap, source_world: torch.Tensor,
                  mask: torch.Tensor, max_range: float = 1.0):
    """Mean squared NN distance of matched points (pcl::Registration::
    getFitnessScore semantics). Returns (score, n_matched) as tensors."""
    _, d2, cnt, _ = ops.knn(grid_cfg, grid, source_world, k=1, max_range=max_range)
    matched = (cnt > 0) & mask
    d = torch.where(matched, d2[0, :], 0.0)
    n = torch.clamp(torch.sum(matched), min=1)
    return torch.sum(d) / n, torch.sum(matched)
