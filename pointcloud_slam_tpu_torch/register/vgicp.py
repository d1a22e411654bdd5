"""Source covariances for (V)GICP (port of `pointcloud_slam_tpu/register/vgicp.py`,
first slice: `_plane_regularize` and `source_covariances`; the rest of VGICP
is not ported yet).

Reference: fast_gicp calculate_covariances with PLANE regularization
(fast_gicp_impl.hpp:241-298); method="exact" is the counterpart of the
reference's GPU `brute_force_knn.cu` -> `covariance_estimation.cu` path and
runs kernel K1 (`ops.bf_knn.knn`) on CUDA tensors.
"""

from __future__ import annotations

import torch

from .. import ops
from ..geom import fit
from ..ops import bf_knn


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
