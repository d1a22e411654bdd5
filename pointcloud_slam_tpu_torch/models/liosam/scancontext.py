"""ScanContext loop-closure descriptors as dense tensor ops (port of
`pointcloud_slam_tpu/models/liosam/scancontext.py`).

Reference: `src/jueying_slam/include/Scancontext.h` + `src/Scancontext.cpp`:
20 rings x 60 sectors of the max point z per polar bin within 80 m; the
ring key is the per-ring mean (kd-tree candidates in the reference); the
distance is the column-shift-aligned mean cosine distance
(`distanceBtnScanContext`), SC_DIST_THRES=0.3, NUM_EXCLUDE_RECENT=30.

The descriptor is a scatter-max into one extra drop slot. The candidate
search is a dense ring-key distance over the keyframe store; the closest
`num_candidates` keys come from a stable sort (JAX's `top_k` keeps the
lowest index first among equal distances, the stable sort does too), and
every circular shift of the query is compared with every candidate at once.
`make_descriptor` takes a leading batch of clouds.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ...ops.downsample import recip32


@dataclasses.dataclass(frozen=True)
class ScanContextConfig:
    num_ring: int = 20
    num_sector: int = 60
    max_radius: float = 80.0
    dist_threshold: float = 0.3      # SC_DIST_THRES
    exclude_recent: int = 30         # NUM_EXCLUDE_RECENT
    num_candidates: int = 10         # NUM_CANDIDATES_FROM_TREE


def make_descriptor(cfg: ScanContextConfig, points: torch.Tensor, mask: torch.Tensor):
    """points (..., 3, N) sensor frame -> (descriptor (..., R, S), ring_key (..., R)).

    Bin value = max z in the bin (0 where empty, the reference's NO_POINT ->
    0 normalization)."""
    R, S = cfg.num_ring, cfg.num_sector
    x, y, z = points[..., 0, :], points[..., 1, :], points[..., 2, :]
    rho = torch.sqrt(x * x + y * y)
    theta = torch.atan2(y, x) + math.pi  # [0, 2pi)
    # bins by float32 reciprocals: jitted XLA folds `x / c * R` into x * (R * (1 / c))
    ring = torch.clamp((rho * recip32(cfg.max_radius, R)).to(torch.int64), max=R - 1)
    sector = torch.clamp((theta * recip32(2 * math.pi, S)).to(torch.int64), max=S - 1)
    ok = mask & (rho < cfg.max_radius)
    flat = torch.where(ok, ring * S + sector, R * S)
    desc = torch.full(points.shape[:-2] + (R * S + 1,), -1.0e9, dtype=points.dtype, device=points.device)
    desc.scatter_reduce_(-1, flat, z, reduce="amax")
    desc = desc[..., : R * S]
    desc = torch.where(desc < -1.0e8, 0.0, desc).reshape(points.shape[:-2] + (R, S))
    # ring key = per-ring mean of bin values (Scancontext.cpp:198-211
    # makeRingkeyFromScancontext: curr_row.mean() including empty bins)
    return desc, torch.mean(desc, dim=-1)


def _shift_distance(query: torch.Tensor, cands: torch.Tensor):
    """Min-over-shifts cosine distance. query (R, S); cands (M, R, S).

    Returns (dist (M,), best_shift (M,)). Column-wise cosine distance
    averaged over non-empty column pairs (Scancontext.cpp distDirectSC)."""
    R, S = query.shape
    ar = torch.arange(S, device=query.device)
    # all S circular shifts of the query (torch.roll by s along columns): (S, R, S)
    shifts = query[:, (ar[None, :] - ar[:, None]) % S].permute(1, 0, 2)
    qn = torch.linalg.norm(shifts, dim=1)  # (S, S) column norms
    cn = torch.linalg.norm(cands, dim=1)   # (M, S)
    dots = torch.einsum("mrc,src->msc", cands, shifts)
    denom = cn[:, None, :] * qn[None, :, :]
    valid = denom > 1e-9
    cs = torch.where(valid, dots / torch.where(valid, denom, 1.0), 0.0)
    ncols = torch.clamp(torch.sum(valid, dim=2), min=1)
    dist = 1.0 - torch.sum(cs, dim=2) / ncols  # (M, S)
    best, best_shift = torch.min(dist, dim=1)
    return best, best_shift.to(torch.int32)


class LoopCandidate(NamedTuple):
    index: torch.Tensor      # best matching keyframe id, -1 if none
    distance: torch.Tensor
    yaw: torch.Tensor        # yaw alignment from the sector shift [rad]
    found: torch.Tensor


def detect(
    cfg: ScanContextConfig,
    query_desc: torch.Tensor,      # (R, S)
    query_key: torch.Tensor,       # (R,)
    descs: torch.Tensor,           # (KF, R, S) keyframe descriptor store
    keys: torch.Tensor,            # (KF, R)
    num_keyframes: torch.Tensor,   # () current count
) -> LoopCandidate:
    """detectLoopClosureID: ring-key candidates -> shift-aligned SC distance."""
    KF = descs.shape[0]
    eligible = torch.arange(KF, device=descs.device) < num_keyframes - cfg.exclude_recent
    key_d2 = torch.where(eligible, torch.sum((keys - query_key[None, :]) ** 2, dim=1), 3.0e38)
    cand_idx = torch.sort(key_d2, stable=True).indices[: cfg.num_candidates]
    cand_ok = key_d2[cand_idx] < 3.0e37
    dist, shift = _shift_distance(query_desc, descs[cand_idx])
    dist = torch.where(cand_ok, dist, 3.0e38)
    best_dist, best = torch.min(dist, dim=0)
    best = best.reshape(1)   # indexing with a 0-d tensor reads it back to the host
    found = best_dist < cfg.dist_threshold
    yaw = shift.index_select(0, best)[0].to(query_desc.dtype) * (2.0 * math.pi / cfg.num_sector)
    index = torch.where(found, cand_idx.index_select(0, best)[0], -1).to(torch.int32)
    return LoopCandidate(index=index, distance=best_dist, yaw=yaw, found=found)
