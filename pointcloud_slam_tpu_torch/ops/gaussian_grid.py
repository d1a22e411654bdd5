"""Gaussian voxel map: per-voxel mean / covariance / inverse-covariance
statistics (port of `pointcloud_slam_tpu/ops/gaussian_grid.py`).

Reference: fast_gicp `fast_vgicp_voxel.hpp` (GaussianVoxel append /
finalize) and `gaussian_voxelmap.cu` for the VGICP target, ndt_omp
`voxel_grid_covariance_omp_impl.hpp` for NDT voxels, and the covariance
regularization modes of `fast_gicp_impl.hpp:241-298` (PLANE) and NDT's
eigenvalue inflation.

The hash table is the voxel grid's: the same fingerprints, probe windows
and claim rounds (`ops/voxel_grid.py`). Accumulation is scatter-add (sum,
outer-product sum, count per slot; `index_add_` sums in another order than
the JAX package's scatter); `finalize` computes mean / cov / icov in closed
form per voxel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom import fit
from .voxel_grid import (GridConfig, _claim_loop, _fingerprint, _hash3, _probe_window, _scatter_drop,
                         point_to_voxel, stencil_offsets)


class GaussianVoxelMap(NamedTuple):
    keys: torch.Tensor      # int32 (3, C)
    fp: torch.Tensor        # int64 (C,) uint32 fingerprint, 0 = empty slot
    occupied: torch.Tensor  # bool (C,)
    sum: torch.Tensor       # (3, C) point sums
    sq: torch.Tensor        # (6, C) outer-product sums [xx, xy, xz, yy, yz, zz]
    count: torch.Tensor     # (C,)
    mean: torch.Tensor      # (3, C) — valid after finalize
    icov: torch.Tensor      # (6, C) inverse covariance (symmetric) — after finalize
    cov: torch.Tensor       # (6, C) regularized covariance — after finalize
    valid: torch.Tensor     # bool (C,) enough points + well-conditioned


def create(config: GridConfig, dtype=torch.float32, device="cuda") -> GaussianVoxelMap:
    """An empty map, on the GPU unless `device` says otherwise."""
    C = config.capacity

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return GaussianVoxelMap(keys=z(3, C, dt=torch.int32), fp=z(C, dt=torch.int64), occupied=z(C, dt=torch.bool),
                            sum=z(3, C), sq=z(6, C), count=z(C), mean=z(3, C), icov=z(6, C), cov=z(6, C),
                            valid=z(C, dt=torch.bool))


def _add_drop(dst: torch.Tensor, idx: torch.Tensor, val: torch.Tensor, dim_size: int) -> torch.Tensor:
    """dst.at[..., idx].add(val, mode="drop"): indices equal to `dim_size` land
    in a sink column that is cut off again."""
    sink = torch.cat([dst, dst.new_zeros(dst.shape[:-1] + (1,))], dim=-1)
    sink.index_add_(sink.dim() - 1, idx, val.to(dst.dtype))
    return sink[..., :dim_size]


def accumulate(config: GridConfig, g: GaussianVoxelMap, points: torch.Tensor, mask: torch.Tensor) -> GaussianVoxelMap:
    """Scatter masked points (3, N) into the per-voxel first/second moments."""
    C = config.capacity
    coords = point_to_voxel(points, config.resolution)
    counter = torch.ones((), dtype=torch.int32, device=points.device)
    stamp0 = torch.zeros((C,), dtype=torch.int32, device=points.device)
    fp, _, _, slot = _claim_loop(config, g.fp, stamp0, counter, coords[0], coords[1], coords[2], mask)
    tgt = torch.where(mask & (slot < C), slot, C)
    x, y, z = points[0], points[1], points[2]
    return g._replace(
        keys=_scatter_drop(g.keys, tgt, coords, C),
        fp=fp,
        occupied=_scatter_drop(g.occupied, tgt, True, C),
        sum=_add_drop(g.sum, tgt, points, C),
        sq=_add_drop(g.sq, tgt, torch.stack([x * x, x * y, x * z, y * y, y * z, z * z]), C),
        count=_add_drop(g.count, tgt, torch.ones_like(x), C),
    )


def finalize(config: GridConfig, g: GaussianVoxelMap, mode: str = "ndt", min_points: int = 6,
             eig_mult: float = 0.01) -> GaussianVoxelMap:
    """Compute mean / regularized covariance / inverse covariance per voxel.

    mode="ndt": inflate small eigenvalues to eig_mult * lambda_max and divide
      by (n - 1) (voxel_grid_covariance_omp_impl.hpp semantics).
    mode="plane": VGICP/GICP PLANE regularization — eigenvalues replaced by
      (1e-3, 1, 1) * lambda_max in the eigenbasis (fast_gicp_impl.hpp:241-298).
    """
    if mode not in ("ndt", "plane"):
        raise ValueError(f"unknown mode {mode!r}")
    cnt = g.count
    ok_n = cnt >= min_points
    inv_n = 1.0 / torch.clamp(cnt, min=1.0)
    mx, my, mz = g.sum[0] * inv_n, g.sum[1] * inv_n, g.sum[2] * inv_n
    denom = torch.clamp(cnt - 1.0, min=1.0) if mode == "ndt" else torch.clamp(cnt, min=1.0)
    c00 = (g.sq[0] - g.sum[0] * mx) / denom
    c01 = (g.sq[1] - g.sum[0] * my) / denom
    c02 = (g.sq[2] - g.sum[0] * mz) / denom
    c11 = (g.sq[3] - g.sum[1] * my) / denom
    c12 = (g.sq[4] - g.sum[1] * mz) / denom
    c22 = (g.sq[5] - g.sum[2] * mz) / denom

    vals, vecs = fit.eigh3x3_soa(c00, c01, c02, c11, c12, c22)
    lmin, lmid, lmax = vals[0], vals[1], vals[2]
    well = lmax > 1e-9
    if mode == "ndt":
        floor = eig_mult * torch.clamp(lmax, min=1e-9)
        l0, l1, l2 = torch.maximum(lmin, floor), torch.maximum(lmid, floor), torch.clamp(lmax, min=1e-9)
    else:  # plane
        scale = torch.clamp(lmax, min=1e-9)
        l0, l1, l2 = 1e-3 * scale, scale, scale

    def rebuild(l0, l1, l2):
        """V diag(l) V^T as its six components."""
        comps = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
        return torch.stack([l0 * vecs[0, i] * vecs[0, j] + l1 * vecs[1, i] * vecs[1, j] + l2 * vecs[2, i] * vecs[2, j]
                            for (i, j) in comps], dim=0)

    cov = rebuild(l0, l1, l2)
    icov = rebuild(*(1.0 / torch.clamp(l, min=1e-12) for l in (l0, l1, l2)))
    valid = g.occupied & ok_n & well
    return g._replace(mean=torch.stack([mx, my, mz]), cov=cov, icov=icov, valid=valid)


def build(config: GridConfig, points: torch.Tensor, mask: torch.Tensor, mode: str = "ndt",
          min_points: int = 6) -> GaussianVoxelMap:
    """create + accumulate + finalize, on the points' device."""
    g = create(config, points.dtype, device=points.device)
    return finalize(config, accumulate(config, g, points, mask), mode=mode, min_points=min_points)


def probe(config: GridConfig, g: GaussianVoxelMap, coords3: tuple) -> torch.Tensor:
    """Slot per query voxel coord (three (N,) int tensors), -1 if absent: the
    first fingerprint match in the probe window."""
    cx, cy, cz = coords3
    win = _probe_window(config, _hash3(cx, cy, cz, config.capacity))     # (P, N)
    match = g.fp[win] == _fingerprint(cx, cy, cz)[None, :]
    first = torch.argmax(match.to(torch.int8), dim=0, keepdim=True)
    return torch.where(match.any(dim=0), torch.gather(win, 0, first)[0], -1)


class BakedGaussianMap(NamedTuple):
    """Stencil-baked Gaussian map: ONE slot lookup returns every stencil
    neighbour's statistics. Every occupied voxel writes its (mean, icov, cov,
    count) into the slot of each query voxel whose stencil contains it; the
    entry index is the stencil-offset index, so entries never collide."""

    fp: torch.Tensor       # int64 (C,) fingerprint of the QUERY voxel, 0 = empty
    entries: torch.Tensor  # (S, 10, C): [valid, mean(3), icov(6)] per stencil entry
    covs: torch.Tensor     # (S, 6, C): regularized covariance (VGICP/D2D consumers)
    counts: torch.Tensor   # (S, C): per-entry point count (VGICP sqrt-count weight)
    dropped: torch.Tensor  # () int32: (voxel, offset) entries lost to capacity overflow


def bake(config: GridConfig, g: GaussianVoxelMap, baked_config: GridConfig) -> BakedGaussianMap:
    """Expand a finalized GaussianVoxelMap into its stencil-baked form.
    `baked_config` sizes the baked table and selects the stencil (`nearby`).
    One-time build cost: S claim loops over the map's capacity."""
    C, C2 = config.capacity, baked_config.capacity
    offs = stencil_offsets(baked_config.nearby)  # (S, 3)
    S, dtype, dev = len(offs), g.mean.dtype, g.mean.device
    fp2 = torch.zeros((C2,), dtype=torch.int64, device=dev)
    stamp0 = torch.zeros((C2,), dtype=torch.int32, device=dev)
    counter = torch.ones((), dtype=torch.int32, device=dev)
    entries = torch.zeros((S, 10, C2), dtype=dtype, device=dev)
    covs = torch.zeros((S, 6, C2), dtype=dtype, device=dev)
    counts = torch.zeros((S, C2), dtype=dtype, device=dev)
    valid = g.valid
    # (10, C) stats with the valid flag leading, zero where not valid
    stats = torch.where(valid, torch.cat([torch.ones((1, C), dtype=dtype, device=dev), g.mean, g.icov]), 0.0)
    cov = torch.where(valid, g.cov, 0.0)
    count = torch.where(valid, g.count, 0.0)
    dropped = torch.zeros((), dtype=torch.int32, device=dev)
    for s, (ox, oy, oz) in enumerate(offs.tolist()):
        # occupied voxel u fills entry s of query voxel v = u - offs[s]
        fp2, _, _, slot = _claim_loop(baked_config, fp2, stamp0, counter,
                                      g.keys[0] - ox, g.keys[1] - oy, g.keys[2] - oz, valid)
        tgt = torch.where(valid & (slot < C2), slot, C2)
        dropped = dropped + torch.sum(valid & (slot >= C2)).to(torch.int32)
        entries[s] = _scatter_drop(entries[s], tgt, stats, C2)
        covs[s] = _scatter_drop(covs[s], tgt, cov, C2)
        counts[s] = _scatter_drop(counts[s], tgt, count, C2)
    return BakedGaussianMap(fp=fp2, entries=entries, covs=covs, counts=counts, dropped=dropped)


def baked_probe(baked_config: GridConfig, bmap: BakedGaussianMap, coords: torch.Tensor,
                rows: torch.Tensor) -> tuple:
    """One fingerprint probe + ONE wide column gather over a baked map.
    coords (3, N) integer query-voxel coords; `rows` (S, R, C) — the
    per-entry rows to gather. Returns (ent (S, R, N), found (N,))."""
    C = baked_config.capacity
    S, R = rows.shape[0], rows.shape[1]
    h0 = _hash3(coords[0], coords[1], coords[2], C)
    match = bmap.fp[_probe_window(baked_config, h0)] == _fingerprint(coords[0], coords[1], coords[2])[None, :]
    jm = torch.argmax(match.to(torch.int8), dim=0)
    safe = (h0 + jm) & (C - 1)
    ent = rows.reshape(S * R, C)[:, safe].reshape(S, R, -1)
    return ent, match.any(dim=0)
