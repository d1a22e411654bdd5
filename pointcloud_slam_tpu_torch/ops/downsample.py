"""Voxel-grid downsampling with static shapes, SoA layout
(port of `pointcloud_slam_tpu/ops/downsample.py`; PCL `VoxelGrid` centroid
filter as the reference uses it, laser_mapping.cc:325).

Outputs keep fixed shapes with a validity mask, so nothing here reads back
from the device. torch has no lexsort: the (x, y, z) voxel-key order is
built from three stable argsorts, minor key first.
"""

from __future__ import annotations

import torch

_BIG = torch.iinfo(torch.int32).max


def _lexsort_voxels(points: torch.Tensor, mask: torch.Tensor, leaf: float):
    """Voxel keys of the masked points, sorted lexicographically (unmasked last).
    Returns (order, sorted coords (3, N), sorted points, valid, is_first, seg_id)."""
    coords = torch.floor(points / leaf).to(torch.int32)
    coords = torch.where(mask[None, :], coords, _BIG)  # unmasked columns sort last
    order = torch.argsort(coords[2], stable=True)
    order = order[torch.argsort(coords[1][order], stable=True)]
    order = order[torch.argsort(coords[0][order], stable=True)]
    sc = coords[:, order]
    sp = points[:, order]
    valid = sc[0] < _BIG
    is_first = torch.ones_like(valid)
    is_first[1:] = torch.any(sc[:, 1:] != sc[:, :-1], dim=0)
    is_first = is_first & valid
    seg_id = torch.cumsum(is_first.to(torch.int64), dim=0) - 1
    return order, sp, valid, is_first, seg_id


def _segment_means(sp, valid, seg_id, n_out: int):
    """Per-segment centroids (3, n_out); segments >= n_out are dropped."""
    tgt = torch.where(valid & (seg_id < n_out), seg_id, n_out)
    seg_sum = torch.zeros((3, n_out + 1), dtype=sp.dtype, device=sp.device).index_add_(1, tgt, sp)
    seg_cnt = torch.zeros((n_out + 1,), dtype=sp.dtype, device=sp.device).index_add_(0, tgt, torch.ones_like(sp[0]))
    return seg_sum[:, :n_out] / torch.clamp(seg_cnt[:n_out], min=1.0)[None, :]


def voxel_downsample(points: torch.Tensor, mask: torch.Tensor, leaf: float):
    """Centroid voxel filter. points (3, N), mask (N,) -> (centroids (3, N), mask' (N,)).

    Output column i holds the centroid of point i's voxel iff i is the first
    masked point of that voxel in voxel-sorted order; other columns keep their
    input value with mask' == False.
    """
    N = points.shape[1]
    order, sp, valid, is_first, seg_id = _lexsort_voxels(points, mask, leaf)
    centroid = _segment_means(sp, valid, seg_id, N)
    # place each segment's centroid at the original index of its first sorted column
    first_tgt = torch.where(is_first, order, N)
    out = torch.cat([points, points.new_zeros((3, 1))], dim=1)
    out[:, first_tgt] = centroid[:, torch.clamp(seg_id, min=0)]
    out_mask = torch.zeros((N + 1,), dtype=torch.bool, device=points.device)
    out_mask[first_tgt] = True
    return out[:, :N], out_mask[:N]


def voxel_downsample_compact(points: torch.Tensor, mask: torch.Tensor, leaf: float, budget: int):
    """Fused `voxel_downsample` + `compact`: the per-segment centroid array,
    packed into a fixed (3, budget) array. Output order is voxel-coord
    lexicographic; segments beyond `budget` are dropped.

    Returns (points (3, budget), mask (budget,)).
    """
    N = points.shape[1]
    budget = min(budget, N)
    _, sp, valid, _, seg_id = _lexsort_voxels(points, mask, leaf)
    # seg_id[-1] is (#segments - 1) (invalid columns sort last and never
    # start a segment); -1 when nothing is valid
    n_seg = seg_id[-1] + 1
    out = _segment_means(sp, valid, seg_id, budget)
    out_mask = torch.arange(budget, device=points.device) < torch.clamp(n_seg, max=budget)
    return out, out_mask


def compact(points: torch.Tensor, mask: torch.Tensor, budget: int):
    """Pack the masked columns of (3, N) into a fixed (3, budget) array, in
    their original order. Masked points beyond `budget` are dropped.

    Returns (points (3, budget), mask (budget,)).
    """
    N = points.shape[1]
    budget = min(budget, N)
    order = torch.argsort((~mask).to(torch.uint8), stable=True)  # masked-True columns first
    out = points[:, order[:budget]]
    n_valid = torch.sum(mask)
    out_mask = torch.arange(budget, device=points.device) < n_valid
    return out, out_mask
