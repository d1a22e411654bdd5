"""Pseudo-Hilbert-curve (PHC) point ordering and sub-voxel centroid merge
(port of `pointcloud_slam_tpu/ops/phc.py`; reference PHC iVox node,
`ivox3d_node.hpp` IVoxNodePhc over `hilbert.hpp`).

Each voxel is split into 2^order sub-cubes per axis. `phc_merge` collapses
every (voxel, sub-cube) cell to the centroid of its points before the map
insert; `phc_sort` orders a batch voxel-major / Hilbert-minor, so that the
per-voxel blocks of `voxel_grid.insert` fill along the curve.

The curve index is Skilling's transpose algorithm ("Programming the Hilbert
curve", AIP Conf. Proc. 707, 2004). The JAX package runs it in uint32; here
it runs in int64, where every value stays below 2^(3 * order) <= 2^30, so
the bits are the same and torch's partial uint32 support is never needed.

Keys follow `ops.point_to_voxel`: coordinates multiply by the float32
reciprocal of the resolution on every device (jitted XLA folds the division
by the constant resolution of `lio_step` the same way). Segment sums run in
sorted order (`downsample._segment_means`), so the card's centroids equal
the CPU's.
"""

from __future__ import annotations

import torch

from .downsample import _segment_means, recip32

_BIG = torch.iinfo(torch.int32).max


def _axes_to_transpose(X, order: int):
    """Skilling AxesToTranspose for n = 3, vectorized. X: 3 int64 tensors."""
    X = list(X)
    for qbit in range(order - 1, 0, -1):
        Q, P = 1 << qbit, (1 << qbit) - 1
        for i in range(3):
            hasq = (X[i] & Q) != 0
            if i == 0:
                X[0] = torch.where(hasq, X[0] ^ P, X[0])
            else:
                t = (X[0] ^ X[i]) & P
                X[0] = torch.where(hasq, X[0] ^ P, X[0] ^ t)
                X[i] = torch.where(hasq, X[i], X[i] ^ t)
    for i in range(1, 3):
        X[i] = X[i] ^ X[i - 1]
    t = torch.zeros_like(X[0])
    for qbit in range(order - 1, 0, -1):
        Q = 1 << qbit
        t = torch.where((X[2] & Q) != 0, t ^ (Q - 1), t)
    return [x ^ t for x in X]


def _transpose_to_axes(X, order: int):
    """Skilling TransposeToAxes for n = 3, vectorized (inverse of the above)."""
    X = list(X)
    t = X[2] >> 1
    for i in range(2, 0, -1):
        X[i] = X[i] ^ X[i - 1]
    X[0] = X[0] ^ t
    for qbit in range(1, order):
        Q, P = 1 << qbit, (1 << qbit) - 1
        for i in range(2, -1, -1):
            hasq = (X[i] & Q) != 0
            if i == 0:
                X[0] = torch.where(hasq, X[0] ^ P, X[0])
            else:
                t = (X[0] ^ X[i]) & P
                X[0] = torch.where(hasq, X[0] ^ P, X[0] ^ t)
                X[i] = torch.where(hasq, X[i], X[i] ^ t)
    return X


def hilbert_index(coords: torch.Tensor, order: int) -> torch.Tensor:
    """3-D Hilbert index of integer sub-cube coords (hilbert::PositionToIndex).

    coords (3, N) in [0, 2^order) -> (N,) int64 in [0, 8^order)."""
    assert 1 <= order <= 10
    X = _axes_to_transpose([coords[i].to(torch.int64) for i in range(3)], order)
    h = torch.zeros_like(X[0])
    for bit in range(order - 1, -1, -1):
        for i in range(3):
            h = (h << 1) | ((X[i] >> bit) & 1)
    return h


def hilbert_coords(h: torch.Tensor, order: int) -> torch.Tensor:
    """Inverse of `hilbert_index`: (N,) -> (3, N) int64 sub-cube coords
    (hilbert::IndexToPosition)."""
    assert 1 <= order <= 10
    h = h.to(torch.int64)
    X = [torch.zeros_like(h) for _ in range(3)]
    for bit in range(order - 1, -1, -1):
        for i in range(3):
            X[i] = (X[i] << 1) | ((h >> (3 * bit + 2 - i)) & 1)
    return torch.stack(_transpose_to_axes(X, order))


def _phc_key(points: torch.Tensor, mask: torch.Tensor, resolution: float, order: int):
    """(voxel coords (3, N) int32, in-voxel Hilbert index (N,) int64); unmasked
    columns get a voxel that sorts last."""
    q = points * recip32(resolution)
    fl = torch.floor(q)
    sub = q - fl                                                     # [0, 1)
    sc = torch.clamp((sub * float(1 << order)).to(torch.int32), 0, (1 << order) - 1)
    h = hilbert_index(sc, order)
    vox = torch.where(mask[None, :], fl.to(torch.int32), _BIG)
    return vox, h


def _curve_order(vox: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The permutation jnp.lexsort((h, vox[2], vox[1], vox[0])) gives: stable
    sorts chained from the least significant key up."""
    order = torch.argsort(h, stable=True)
    for row in (2, 1, 0):
        order = order[torch.argsort(vox[row][order], stable=True)]
    return order


def phc_merge(points: torch.Tensor, mask: torch.Tensor, resolution: float, order: int,
              curve_output: bool = False):
    """Centroid-merge every Hilbert sub-cube (IVoxNodePhc::InsertPoint role).

    points (3, N), mask (N,) -> (merged (3, N), mask' (N,)). With
    curve_output=False, column i holds the centroid of point i's (voxel,
    sub-cube) cell iff i is the cell's first masked point in curve order;
    other columns keep their input and are masked out. With curve_output=True
    the centroids are packed at the front in voxel-major / Hilbert-minor
    order (a free compaction)."""
    N = points.shape[1]
    vox, h = _phc_key(points, mask, resolution, order)
    order_idx = _curve_order(vox, h)
    sv, sh, sp = vox[:, order_idx], h[order_idx], points[:, order_idx]
    valid = sv[0] < _BIG
    is_first = torch.ones_like(valid)
    is_first[1:] = torch.any(sv[:, 1:] != sv[:, :-1], dim=0) | (sh[1:] != sh[:-1])
    is_first = is_first & valid
    seg_id = torch.cumsum(is_first.to(torch.int64), dim=0) - 1
    centroid = _segment_means(sp, valid, seg_id, N)
    if curve_output:
        # segment ids grow along the curve: the centroid array is the output
        out_mask = torch.arange(N, device=points.device) < torch.sum(is_first)
        return centroid, out_mask
    first_tgt = torch.where(is_first, order_idx, N)
    out = torch.cat([points, points.new_zeros((3, 1))], dim=1)
    out[:, first_tgt] = centroid[:, torch.clamp(seg_id, min=0)]
    out_mask = torch.zeros((N + 1,), dtype=torch.bool, device=points.device)
    out_mask.index_fill_(0, first_tgt, True)
    return out[:, :N], out_mask[:N]


def phc_sort(points: torch.Tensor, mask: torch.Tensor, resolution: float, order: int):
    """Order a batch along the voxel-major / Hilbert-minor curve; unmasked
    columns sort last. Returns (points (3, N), mask (N,))."""
    vox, h = _phc_key(points, mask, resolution, order)
    order_idx = _curve_order(vox, h)
    return points[:, order_idx], mask[order_idx]
