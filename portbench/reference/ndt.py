"""Point-to-distribution NDT registration against a Gaussian voxel map: the
benchmark's plain reference. A frozen copy of
`pointcloud_slam_tpu_torch/register/ndt.py` at commit 9c22c1c (the D2D mode
and the source voxelization left out), with the final eigenvalues from
`torch.linalg.eigvalsh` and the helpers it took from `register/vgicp.py`
copied in.

Reference: `pointcloud_match/ndt_omp/include/pclomp/ndt_omp.h` /
`ndt_omp_impl.hpp` — Magnusson's NDT with the exponential score
s = -d1 exp(-d2/2 q^T S^-1 q), gauss_d1/d2 from the outlier ratio,
DIRECT1/7/27 stencil correspondences and the Hessian-eigenvalue export
(`getMaxEigen`, ndt_omp.h:209-223).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from . import gaussian_grid as gg
from . import se3, solver
from . import voxel_grid as ops
from .voxel_grid import _stencil_tensor


def _sym3(c6: torch.Tensor) -> torch.Tensor:
    """Six symmetric components (6, ...) -> full matrices (3, 3, ...)."""
    a00, a01, a02, a11, a12, a22 = c6
    return torch.stack([torch.stack([a00, a01, a02]), torch.stack([a01, a11, a12]), torch.stack([a02, a12, a22])])


def _point_jacobian(p: torch.Tensor) -> torch.Tensor:
    """dq/d[omega, v] = [-hat(p) | I] of world points p (3, ...): (3, 6, ...)."""
    px, py, pz = p[0], p[1], p[2]
    zero, one = torch.zeros_like(px), torch.ones_like(px)
    return torch.stack([torch.stack([zero, pz, -py, one, zero, zero]),
                        torch.stack([-pz, zero, px, zero, one, zero]),
                        torch.stack([py, -px, zero, zero, zero, one])])


@dataclasses.dataclass(frozen=True)
class NDTConfig:
    resolution: float = 1.0
    outlier_ratio: float = 0.55      # pclomp default
    min_points_per_voxel: int = 6
    nearby: int = 7                  # DIRECT1 / DIRECT7 / DIRECT27
    search_every: int = 5
    # one-iteration rounds before the regular cadence (see Scan2MapConfig)
    warmup_searches: int = 2
    solver: solver.SolverConfig = dataclasses.field(
        default_factory=lambda: solver.SolverConfig(max_iterations=35)
    )

    def gauss_coeffs(self):
        """(d1, d2) from resolution + outlier ratio (ndt_omp_impl.hpp init)."""
        c1 = 10.0 * (1.0 - self.outlier_ratio)
        c2 = self.outlier_ratio / (self.resolution ** 3)
        d3 = -math.log(c2)
        d1 = -math.log(c1 + c2) - d3
        d2 = -2.0 * math.log((-math.log(c1 * math.exp(-0.5) + c2) - d3) / d1)
        return d1, d2


class NDTResult(NamedTuple):
    pose: se3.Pose
    converged: torch.Tensor
    iterations: torch.Tensor
    score: torch.Tensor
    H: torch.Tensor          # (6, 6) final Hessian (getFinalHessian / getMaxEigen)
    max_eigen: torch.Tensor  # largest Hessian eigenvalue (degeneracy judge)


def build_target(cfg: NDTConfig, target: torch.Tensor, mask: Optional[torch.Tensor] = None,
                 capacity: int = 1 << 16, baked: bool = False, baked_capacity: Optional[int] = None):
    """Voxelize the target cloud into Gaussian statistics (VoxelGridCovariance)
    on the target's device. baked=True expands the map with gg.bake: a search
    is then one probe and one wide gather per point instead of `nearby`
    probes — identical results; `baked_capacity` (default 4x) must exceed the
    voxels any stencil neighbourhood covers (a shortfall warns, the one host
    read of a baked build)."""
    if mask is None:
        mask = torch.ones(target.shape[1], dtype=torch.bool, device=target.device)
    grid_cfg = ops.GridConfig(capacity=capacity, resolution=cfg.resolution, nearby=cfg.nearby)
    g = gg.build(grid_cfg, target, mask, mode="ndt", min_points=cfg.min_points_per_voxel)
    if not baked:
        return grid_cfg, g
    baked_cfg = ops.GridConfig(capacity=baked_capacity or 4 * capacity, resolution=cfg.resolution,
                               nearby=cfg.nearby)
    baked_map = gg.bake(grid_cfg, g, baked_cfg)
    if int(baked_map.dropped):
        raise RuntimeError(f"the bake dropped {int(baked_map.dropped)} stencil entries: raise baked_capacity")
    return baked_cfg, baked_map


def _correspond(cfg: NDTConfig, grid_cfg, g: gg.GaussianVoxelMap, pw, mask):
    """Per (point, stencil-voxel) Gaussians: means (3,S,N), icovs (6,S,N),
    valid (S,N); statistics are zero where not valid."""
    slot = gg.probe_stencil(grid_cfg, g, ops.point_to_voxel(pw, cfg.resolution), cfg.nearby)
    safe = torch.clamp(slot, min=0)
    valid = (slot >= 0) & g.valid[safe] & mask[None, :]
    return (torch.where(valid, g.mean[:, safe], 0.0), torch.where(valid, g.icov[:, safe], 0.0), valid)


def _correspond_baked(cfg: NDTConfig, baked_cfg, b: gg.BakedGaussianMap, pw, mask):
    """Stencil-baked correspondence: same outputs as _correspond from ONE
    fingerprint probe + ONE (S*10, C) column gather per query (gg.baked_probe)."""
    coords = ops.point_to_voxel(pw, cfg.resolution)
    ent, found = gg.baked_probe(baked_cfg, b, coords, b.entries)
    valid = (ent[:, 0] > 0.5) & found[None, :] & mask[None, :]
    return (torch.where(valid, ent[:, 1:4].transpose(0, 1), 0.0),
            torch.where(valid, ent[:, 4:10].transpose(0, 1), 0.0), valid)


def _linearize_cached(d1, d2, means, icovs, valid, pw, src):
    """GN linearization of the NDT exponential score at pose-transformed pw.

    Per correspondence: q = pw - mean; e = q^T S^-1 q; score contribution
    -d1 exp(-d2/2 e); weight w = -d1 d2 exp(-d2/2 e) > 0 (d1 < 0). The
    Jacobian depends only on the point, so the stencil axis collapses first:
    per point r = sum_s w S^-1 q and A = sum_s w S^-1, then
    b = sum_n J^T r and H = sum_n J^T A J. Returns (H, b, -score)."""
    q = pw[:, None, :] - means                                    # (3, S, N)
    Sq = torch.einsum("abpn,bpn->apn", _sym3(icovs), q)           # S^-1 q
    e = torch.clamp(torch.sum(q * Sq, dim=0), 0.0, 50.0)
    w = torch.where(valid, -d1 * d2 * torch.exp(-0.5 * d2 * e), 0.0)
    score = torch.sum(w) / d2
    r = torch.sum(w * Sq, dim=1)                                   # (3, N)
    A = _sym3(torch.sum(w * icovs, dim=1))                         # (3, 3, N)
    J = _point_jacobian(pw)
    AJ = torch.einsum("abn,bin->ain", A, J)
    H = torch.einsum("ain,ajn->ij", J, AJ)
    b = torch.einsum("ain,an->i", J, r)
    return 0.5 * (H + H.T), b, -score


def align(
    grid_cfg: ops.GridConfig,
    target,
    source: torch.Tensor,
    source_mask: Optional[torch.Tensor] = None,
    init_pose: Optional[se3.Pose] = None,
    cfg: NDTConfig = NDTConfig(),
) -> NDTResult:
    """Align source (3, N) to the NDT target map (a GaussianVoxelMap with its
    grid config, or a BakedGaussianMap with its baked config)."""
    if source_mask is None:
        source_mask = torch.ones(source.shape[1], dtype=torch.bool, device=source.device)
    if init_pose is None:
        init_pose = se3.identity(source.dtype, device=source.device)
    d1, d2 = cfg.gauss_coeffs()
    scfg = cfg.solver
    baked = isinstance(target, gg.BakedGaussianMap)

    def search(pose):
        pw = pose.apply(source)
        if baked:
            return _correspond_baked(cfg, grid_cfg, target, pw, source_mask)
        return _correspond(cfg, grid_cfg, target, pw, source_mask)

    pose = init_pose
    done, iters = solver._start(init_pose)
    warmup = min(cfg.warmup_searches, scfg.max_iterations)
    rest = scfg.max_iterations - warmup
    n_rounds = -(-rest // cfg.search_every) if rest > 0 else 0
    cache = None
    for chunk in [1] * warmup + [cfg.search_every] * n_rounds:
        cache = search(pose)
        done = done | (iters >= scfg.max_iterations)
        for _ in range(chunk):
            H, b, _ = _linearize_cached(d1, d2, *cache, pose.apply(source), source)
            pose, done, iters, _ = solver._gn_update(H, b, pose, done, iters, scfg,
                                                     lam=1e-6 * H.diagonal().abs().amax())
    if cache is None:  # max_iterations = 0: no correspondences, zero terms
        S, N = _stencil_tensor(cfg.nearby, source.device).shape[1], source.shape[1]
        cache = (source.new_zeros((3, S, N)), source.new_zeros((6, S, N)),
                 torch.zeros((S, N), dtype=torch.bool, device=source.device))
    H, b, err = _linearize_cached(d1, d2, *cache, pose.apply(source), source)
    return NDTResult(pose, done, iters, -err, H, torch.linalg.eigvalsh(H)[-1])
