"""Large-world maps: unbounded 2-D occupancy tiling + hash-based 3-D occupancy
(port of `pointcloud_slam_tpu/maps/tiled.py`).

Behavioral parity targets, as in the JAX package:
  - `TiledOccupancyMap` replaces the reference's expandable quadtree
    (`occupancy_map.hpp` `extendMap` :114-149): a host dict of fixed-size
    dense device tiles; a scan updates every tile it can reach, each with
    the tile's origin passed at run time. Stitching gives one grid + origin.
  - `VoxelOccupancy3D` plays the octomap_server role
    (`OctomapServer.cpp` insertCloudCallback): log-odds per 3-D voxel in a
    fixed-capacity direct-addressed hash table — unbounded extent in bounded
    memory (a slot claimed by another voxel is recycled).

Hashes and fingerprints are the port's voxel-grid ones, bit-identical to the
JAX package's; `fp` holds the uint32 fingerprint as int64. Where several
points of one batch aim at one slot, one writer wins the whole slot: the
last valid one in batch order (XLA's scatter order on the CPU), chosen by a
`scatter_reduce_("amax")` over the batch index, and every field of the slot
is written from it. Four independent scatters, as in the JAX code, could
leave a slot on the card whose coordinates belong to one voxel and whose
fingerprint to another.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.downsample import recip32
from ..ops.voxel_grid import _fingerprint, _hash3
from . import occupancy as occ


class TiledOccupancyMap:
    """Host-side unbounded 2-D occupancy map over device tiles.

    Tiles are created on demand as the trajectory expands (extendMap role).
    Poses are host values (floats or numpy), as in the JAX package."""

    def __init__(self, cfg: occ.OccupancyConfig, device="cuda"):
        self.cfg = cfg
        self.device = device
        self.tile_extent = cfg.size * cfg.resolution
        self.tiles: Dict[Tuple[int, int], occ.OccupancyGrid] = {}

    def _tile_of(self, x: float, y: float) -> Tuple[int, int]:
        return (int(math.floor(x / self.tile_extent)), int(math.floor(y / self.tile_extent)))

    def _origin(self, key: Tuple[int, int]) -> np.ndarray:
        return np.asarray([key[0] * self.tile_extent, key[1] * self.tile_extent], np.float32)

    def touched_tiles(self, x: float, y: float):
        """Tiles a scan at (x, y) can reach (pose ± max_range square)."""
        r = self.cfg.max_range
        t0 = self._tile_of(x - r, y - r)
        t1 = self._tile_of(x + r, y + r)
        return [(i, j) for i in range(t0[0], t1[0] + 1) for j in range(t0[1], t1[1] + 1)]

    def insert_cloud(self, points, mask, pose_xy, pose_yaw):
        """Update every touched tile from one world-frame cloud (3, N)."""
        xy = np.asarray(pose_xy, np.float32)
        x, y = float(xy[0]), float(xy[1])
        for key in self.touched_tiles(x, y):
            tile = self.tiles.get(key)
            if tile is None:
                tile = occ.create(self.cfg, dtype=points.dtype, device=self.device)
            self.tiles[key] = occ.insert_cloud(self.cfg, tile, points, mask, xy, float(np.float32(pose_yaw)),
                                               origin=self._origin(key))

    def stitch(self):
        """All tiles into one numpy log-odds array. Returns (logodds, origin_xy)."""
        if not self.tiles:
            raise ValueError("empty map")
        keys = list(self.tiles.keys())
        i0 = min(k[0] for k in keys)
        j0 = min(k[1] for k in keys)
        i1 = max(k[0] for k in keys)
        j1 = max(k[1] for k in keys)
        S = self.cfg.size
        out = np.zeros(((i1 - i0 + 1) * S, (j1 - j0 + 1) * S), np.float32)
        for (i, j), tile in self.tiles.items():
            out[(i - i0) * S : (i - i0 + 1) * S, (j - j0) * S : (j - j0 + 1) * S] = tile.logodds.cpu().numpy()
        origin = np.asarray([i0 * self.tile_extent, j0 * self.tile_extent], np.float32)
        return out, origin

    def save_pgm(self, path: str):
        """Stitched PGM + YAML with the true world origin (non-square
        stitches are zero-padded to a square, as in the JAX package)."""
        lo, origin = self.stitch()
        n = max(lo.shape)
        pad = np.zeros((n, n), np.float32)
        pad[: lo.shape[0], : lo.shape[1]] = lo
        occ.save_pgm(dataclasses.replace(self.cfg, size=n), occ.OccupancyGrid(logodds=pad), path, origin=origin)


# ---------------------------------------------------------------------------
# 3-D hash-based occupancy (octomap_server role)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VoxelOccConfig:
    capacity: int = 1 << 20          # voxel slots (power of two)
    resolution: float = 0.2          # m / voxel
    n_free_steps: int = 32           # free-space samples per beam
    logodd_occ: float = 0.85         # octomap defaults: hit 0.85, miss -0.4
    logodd_free: float = -0.4
    logodd_min: float = -2.0         # octomap clamping thresholds
    logodd_max: float = 3.5
    occ_thresh_logodd: float = 0.0   # occupied when logodds > 0

    def __post_init__(self):
        if self.capacity & (self.capacity - 1):
            raise ValueError("capacity must be a power of two")


class VoxelOccupancy3D(NamedTuple):
    fp: torch.Tensor        # (C,) int64 holding the uint32 voxel fingerprint (0 = empty)
    keys: torch.Tensor      # (3, C) int32 voxel coords (for export)
    logodds: torch.Tensor   # (C,)


def create_3d(cfg: VoxelOccConfig, dtype=torch.float32, device="cuda") -> VoxelOccupancy3D:
    """An empty map, on the GPU unless `device` says otherwise."""
    C = cfg.capacity
    return VoxelOccupancy3D(
        fp=torch.zeros((C,), dtype=torch.int64, device=device),
        keys=torch.zeros((3, C), dtype=torch.int32, device=device),
        logodds=torch.zeros((C,), dtype=dtype, device=device),
    )


def _slot_update(cfg, m: VoxelOccupancy3D, cx, cy, cz, delta, valid, collisions=None):
    """Scatter log-odds deltas into direct-addressed voxel slots.

    A slot holding a DIFFERENT voxel is recycled (log-odds reset to 0, then
    every valid delta aimed at it is added) and takes the identity of its
    batch winner: the last valid writer in batch order. With `collisions`
    (a 0-d int64 tensor) given, the slots where some valid writer's voxel
    lost to another voxel of this batch are added to it."""
    C = cfg.capacity
    dev = m.fp.device
    s = _hash3(cx, cy, cz, C)
    fpq = _fingerprint(cx, cy, cz)
    tgt = torch.where(valid, s, C)
    reset = valid & (m.fp[s] != fpq)
    logodds = torch.cat([m.logodds, m.logodds.new_zeros(1)])
    logodds.index_fill_(0, torch.where(reset, tgt, C), 0.0)
    logodds.index_add_(0, tgt, torch.full(tgt.shape, delta, dtype=logodds.dtype, device=dev))
    logodds = torch.clamp(logodds[:C], cfg.logodd_min, cfg.logodd_max)
    # one winner per slot: the largest valid batch index aimed at it
    order = torch.arange(tgt.shape[0], device=dev)
    winner = torch.full((C + 1,), -1, dtype=torch.int64, device=dev).scatter_reduce_(0, tgt, order, "amax")
    won = valid & (winner[tgt] == order)
    wt = torch.where(won, tgt, C)
    fp = torch.cat([m.fp, m.fp.new_zeros(1)])
    fp[wt] = fpq
    keys = torch.cat([m.keys, m.keys.new_zeros((3, 1))], dim=1)
    keys[:, wt] = torch.stack([cx, cy, cz]).to(torch.int32)
    if collisions is not None:
        lost = valid & (fp[tgt] != fpq)
        flag = torch.zeros((C + 1,), dtype=torch.int64, device=dev).index_fill_(0, torch.where(lost, tgt, C), 1)
        collisions += flag[:C].sum()
    return VoxelOccupancy3D(fp=fp[:C], keys=keys[:, :C], logodds=logodds)


def insert_cloud_3d(cfg: VoxelOccConfig, m: VoxelOccupancy3D, points: torch.Tensor, mask: torch.Tensor, origin,
                    collisions: Optional[torch.Tensor] = None) -> VoxelOccupancy3D:
    """octomap insertCloudCallback: for each beam origin->point, free-space
    samples along the ray and an occupied hit at the endpoint. `origin` (3,)
    is a tensor or three host floats; `collisions`: see `_slot_update`."""
    res = cfg.resolution
    o = origin if torch.is_tensor(origin) else torch.tensor(np.asarray(origin, np.float32))
    o = o.to(device=points.device, dtype=points.dtype, non_blocking=True)
    d = points - o[:, None]                      # (3, N)
    # free samples strictly inside the beam (exclude the hit voxel)
    # (products by float32 reciprocals: see ops.downsample.recip32)
    fr = (torch.arange(cfg.n_free_steps, dtype=points.dtype, device=points.device) + 0.5) * recip32(
        cfg.n_free_steps + 1)
    fpts = o[:, None, None] + d[:, None, :] * fr[None, :, None]   # (3, S, N)
    fx = torch.floor(fpts * recip32(res)).to(torch.int32)
    # drop free samples that fall in the endpoint's voxel
    ex = torch.floor(points * recip32(res)).to(torch.int32)       # (3, N)
    in_end = torch.all(fx == ex[:, None, :], dim=0)
    fvalid = mask[None, :] & ~in_end
    m = _slot_update(cfg, m, fx[0].reshape(-1), fx[1].reshape(-1), fx[2].reshape(-1), cfg.logodd_free,
                     fvalid.reshape(-1), collisions)
    return _slot_update(cfg, m, ex[0], ex[1], ex[2], cfg.logodd_occ, mask, collisions)


def occupied_voxels(cfg: VoxelOccConfig, m: VoxelOccupancy3D):
    """Occupied voxel centers (host): (M, 3) float32."""
    lo = m.logodds.cpu().numpy()
    fp = m.fp.cpu().numpy()
    sel = (fp != 0) & (lo > cfg.occ_thresh_logodd)
    keys = m.keys.cpu().numpy()[:, sel]
    return (keys.T.astype(np.float32) + 0.5) * cfg.resolution


def project_2d(cfg: VoxelOccConfig, m: VoxelOccupancy3D, z_min: float, z_max: float,
               size: int, res2d: float, origin_xy):
    """2-D down-projection of the occupied voxels in a z band — the
    octomap_server downprojected 2-D map. Returns an int8 trinary grid (numpy)."""
    pts = occupied_voxels(cfg, m)
    sel = (pts[:, 2] >= z_min) & (pts[:, 2] <= z_max)
    pts = pts[sel]
    gi = np.floor((pts[:, 0] - origin_xy[0]) / res2d).astype(np.int64)
    gj = np.floor((pts[:, 1] - origin_xy[1]) / res2d).astype(np.int64)
    ok = (gi >= 0) & (gi < size) & (gj >= 0) & (gj < size)
    out = np.full((size, size), -1, np.int8)
    out[gi[ok], gj[ok]] = 100
    return out
