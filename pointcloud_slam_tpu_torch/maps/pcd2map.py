"""Cloud post-processing: voxel downsample + z-band slice (pcd2map pipeline)
and a bounded dense 3-D occupancy volume (port of
`pointcloud_slam_tpu/maps/pcd2map.py`).

Behavioral parity targets, as in the JAX package:
  - `src/tool/pcd2map/src/pcd2map.cpp:20-100`: load PCD -> VoxelGrid
    downsample -> PassThrough z band -> the navigation cloud,
  - `src/tool/octomap_server/src/OctomapServer.cpp`: 3-D insertion + 2-D
    downprojection, here over a dense volume of hit counts.

The volume's hit counts are int32 (torch's uint32 has no scatter-add); the
JAX package keeps uint32, and `convert.py` carries them across.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import ops
from ..ops.downsample import recip32


def z_band_filter(points: torch.Tensor, mask: torch.Tensor, z_min: float, z_max: float) -> torch.Tensor:
    """PassThrough on z (pcd2map.cpp passthrough)."""
    return mask & (points[2] >= z_min) & (points[2] <= z_max)


def pcd_to_nav_cloud(points: torch.Tensor, mask: torch.Tensor, leaf: float, z_min: float, z_max: float):
    """The pcd2map product: downsampled, z-sliced cloud (3, N) + mask."""
    pts, m = ops.voxel_downsample(points, mask, leaf)
    return pts, z_band_filter(pts, m, z_min, z_max)


@dataclasses.dataclass(frozen=True)
class VolumeConfig:
    """Dense 3-D occupancy volume (octomap_server role over a bounded box)."""

    nx: int = 512
    ny: int = 512
    nz: int = 64
    resolution: float = 0.2
    origin: tuple = (-51.2, -51.2, -3.2)


class OccupancyVolume(NamedTuple):
    hits: torch.Tensor  # int32 (nx, ny, nz) hit counts


def create_volume(cfg: VolumeConfig, device="cuda") -> OccupancyVolume:
    """An empty volume, on the GPU unless `device` says otherwise."""
    return OccupancyVolume(hits=torch.zeros((cfg.nx, cfg.ny, cfg.nz), dtype=torch.int32, device=device))


def insert_volume(cfg: VolumeConfig, vol: OccupancyVolume, points: torch.Tensor, mask: torch.Tensor) -> OccupancyVolume:
    """Add one hit to the cell of every masked point inside the volume."""
    ox, oy, oz = cfg.origin
    inv = recip32(cfg.resolution)   # as the card divides by a host scalar (ops.downsample.recip32)
    i = torch.floor((points[0] - ox) * inv).to(torch.int64)
    j = torch.floor((points[1] - oy) * inv).to(torch.int64)
    k = torch.floor((points[2] - oz) * inv).to(torch.int64)
    ok = mask & (i >= 0) & (i < cfg.nx) & (j >= 0) & (j < cfg.ny) & (k >= 0) & (k < cfg.nz)
    n = cfg.nx * cfg.ny * cfg.nz
    flat = torch.where(ok, (i * cfg.ny + j) * cfg.nz + k, n)
    hits = torch.cat([vol.hits.reshape(-1), vol.hits.new_zeros(1)])
    hits.index_add_(0, flat, torch.ones_like(flat, dtype=hits.dtype))
    return OccupancyVolume(hits=hits[:n].reshape(cfg.nx, cfg.ny, cfg.nz))


def project_2d(cfg: VolumeConfig, vol: OccupancyVolume, min_hits: int = 2) -> torch.Tensor:
    """OctomapServer 2-D downprojection: a column is occupied if any z cell is."""
    return torch.any(vol.hits >= min_hits, dim=2)
