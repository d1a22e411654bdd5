"""LOAM feature extraction over the dense range image (port of
`pointcloud_slam_tpu/models/liosam/features.py`).

Reference: `src/jueying_slam/src/featureExtraction.cpp` —
`calculateSmoothness` (:84-105): curvature = (sum of +-5 range neighbours
- 10 r)^2; `markOccludedPoints` (:107-145): occlusion and parallel-beam
rejection; `extractFeatures` (:147-246): per ring, 6 azimuth sectors, up to
20 sharpest edges (curvature > edgeThreshold), surfaces = curvature <
surfThreshold, neighbour suppression around picked edges.

Fixed-shape ops on the (n_scan, horizon) image: curvature by shifted sums,
per-sector selection by a stable descending sort (JAX's `top_k` keeps the
lowest column first among equal curvatures; the stable sort does too),
suppression by shifted masks.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .projection import _INF, RangeImage


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    edge_threshold: float = 1.0      # edgeThreshold (utility.h)
    surf_threshold: float = 0.1      # surfThreshold
    n_sectors: int = 6               # per-ring azimuth split
    max_edge_per_sector: int = 20
    occlusion_jump: float = 0.3
    parallel_frac: float = 0.02
    half_window: int = 5


class Features(NamedTuple):
    curvature: torch.Tensor   # (S, H)
    edge_mask: torch.Tensor   # (S, H)
    surf_mask: torch.Tensor   # (S, H)


def _shift_cols(a: torch.Tensor, k: int, fill) -> torch.Tensor:
    """Shift along the column axis with fill (no wraparound — ring ends don't
    see each other, matching the reference's index bounds)."""
    if k == 0:
        return a
    pad = torch.full((a.shape[0], abs(k)), fill, dtype=a.dtype, device=a.device)
    if k > 0:
        return torch.cat([pad, a[:, :-k]], dim=1)
    return torch.cat([a[:, -k:], pad], dim=1)


def extract(cfg: FeatureConfig, img: RangeImage) -> Features:
    S, H = img.rng.shape
    v = img.valid
    r = torch.where(v, img.rng, 0.0)

    # curvature over +-half_window valid windows
    acc = -2.0 * cfg.half_window * r
    cnt_ok = v
    for k in range(1, cfg.half_window + 1):
        acc = acc + _shift_cols(r, k, 0.0) + _shift_cols(r, -k, 0.0)
        cnt_ok = cnt_ok & _shift_cols(v, k, False) & _shift_cols(v, -k, False)
    curvature = acc * acc

    # occlusion: big range jump between adjacent columns hides a band of 5
    nxt = _shift_cols(r, -1, _INF)
    occl_right = v & (r - nxt > cfg.occlusion_jump)
    occl_left = v & (nxt - r > cfg.occlusion_jump)
    blocked = torch.zeros_like(v)
    for k in range(0, 6):
        blocked = blocked | _shift_cols(occl_right, -k, False)
        blocked = blocked | _shift_cols(occl_left, k + 1, False)
    # parallel beams: both neighbours differ by > 2% of range
    d1 = torch.abs(_shift_cols(r, 1, 0.0) - r)
    d2 = torch.abs(_shift_cols(r, -1, 0.0) - r)
    parallel = v & (d1 > cfg.parallel_frac * r) & (d2 > cfg.parallel_frac * r)

    good = cnt_ok & ~blocked & ~parallel

    # sector split + the sharpest max_edge_per_sector per sector
    Hs = H // cfg.n_sectors
    curv_sec = torch.where(good, curvature, -1.0).reshape(S, cfg.n_sectors, Hs)
    topv, topi = torch.sort(curv_sec, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., : cfg.max_edge_per_sector], topi[..., : cfg.max_edge_per_sector]
    edge_sec = torch.zeros((S, cfg.n_sectors, Hs), dtype=torch.bool, device=v.device)
    edge_sec.scatter_(-1, topi, topv > cfg.edge_threshold)
    edge_mask = edge_sec.reshape(S, H) & good

    # neighbour suppression around edges (the reference marks +-5 neighbours picked)
    sup = edge_mask
    for k in range(1, cfg.half_window + 1):
        sup = sup | _shift_cols(edge_mask, k, False) | _shift_cols(edge_mask, -k, False)
    surf_mask = good & (curvature < cfg.surf_threshold) & ~sup
    return Features(curvature=curvature, edge_mask=edge_mask, surf_mask=surf_mask)


def gather_features(img: RangeImage, mask2d: torch.Tensor):
    """Flatten an image feature mask into an SoA cloud (3, S*H) + mask."""
    pts = torch.stack([img.x.reshape(-1), img.y.reshape(-1), img.z.reshape(-1)], dim=0)
    return pts, mask2d.reshape(-1)


def front_end(pcfg, cfg: FeatureConfig, pts: torch.Tensor, mask: torch.Tensor):
    """Range-image projection + feature extraction of one scan, the
    imageProjection -> featureExtraction stages the apps run before
    matching: (corner pts, corner mask, surf pts, surf mask), each over the
    whole image."""
    from .projection import project

    img = project(pcfg, pts, mask)
    fs = extract(cfg, img)
    cpts, cmask = gather_features(img, fs.edge_mask)
    spts, smask = gather_features(img, fs.surf_mask)
    return cpts, cmask, spts, smask


def fixed_size(pts: torch.Tensor, mask: torch.Tensor, n: int):
    """The first n masked points, in index order, as a fixed-shape (3, n)
    cloud and its mask (zeros past the masked ones); on the device, with no
    host read. The JAX apps' `fixed` picks the same count with numpy's
    unstable `argsort(~mask)`, whose choice among more than n masked points
    may differ."""
    N = mask.shape[0]
    if N < n:
        pts = torch.cat([pts, pts.new_zeros((3, n - N))], dim=1)
        mask = torch.cat([mask, mask.new_zeros(n - N)])
    idx = torch.argsort((~mask).to(torch.uint8), stable=True)[:n]
    m = mask[idx]
    return torch.where(m, pts[:, idx], 0.0), m


def spread_size(pts: torch.Tensor, mask: torch.Tensor, n: int):
    """n masked points spread evenly over the masked ones in index order (the
    j-th of n is the floor(j * count / n)-th masked point), as a fixed-shape
    (3, n) cloud and its mask; all of them, as `fixed_size` gives them, when
    there are no more than n. On the device, with no host read.

    A range image's features come ring by ring, so `fixed_size`'s first n
    hold the lowest rings only: on a spinning LiDAR's scan that is one or two
    floor arcs, whose 5-point neighbourhoods are near collinear and whose
    plane fits let scan-to-map drift in z. Spread over every ring, the same
    count tracks (tests/test_torch_replay.py's ring-structured bag)."""
    N = mask.shape[0]
    if N < n:
        pts = torch.cat([pts, pts.new_zeros((3, n - N))], dim=1)
        mask = torch.cat([mask, mask.new_zeros(n - N)])
    order = torch.argsort((~mask).to(torch.uint8), stable=True)       # masked points first, in order
    count = torch.sum(mask)
    j = torch.arange(n, device=mask.device)
    idx = order.index_select(0, (j * torch.clamp(count, min=n)) // n)
    m = j < count
    return torch.where(m, pts[:, idx], 0.0), m
