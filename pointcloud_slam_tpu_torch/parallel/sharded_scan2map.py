"""Point-axis-sharded LOAM scan-to-map matching over a device mesh (port of
`pointcloud_slam_tpu/parallel/sharded_scan2map.py`).

The SLAM front end's corner and surface loops (mapOptmization.cpp:1259,1353)
across ranks: each rank searches, fits and builds Jacobian rows for its
shard of both feature sets, and the 6x6 H, the 6 b and the match counts are
all-reduced over the axis at every linearization (`scan_to_map`'s `reduce`
hook). The pose iteration, the local maps and the degeneracy projector are
replicated; every rank reads the same reduced H, so every rank takes the
same branch.
"""

from __future__ import annotations

from ..models.liosam import scan2map as s2m
from . import mesh as mesh_mod


def sharded_scan_to_map(mesh, cfg: s2m.Scan2MapConfig, corner_map, surf_map, corner_pts, corner_mask, surf_pts,
                        surf_mask, init_pose, axis: str = "sp") -> s2m.Scan2MapResult:
    """LOAM scan-to-map with both feature point axes sharded on `axis`.

    corner_pts (3, Nc) / surf_pts (3, Ns) and their masks: the same on every
    rank, Nc and Ns divisible by the axis size; the maps and init_pose
    replicated. Returns the Scan2MapResult of the whole scan (global match
    counts), the same on every rank."""
    return s2m.scan_to_map(
        cfg, corner_map, surf_map,
        mesh_mod.shard(corner_pts, mesh, axis, 1), mesh_mod.shard(corner_mask, mesh, axis, 0),
        mesh_mod.shard(surf_pts, mesh, axis, 1), mesh_mod.shard(surf_mask, mesh, axis, 0),
        init_pose, reduce=mesh_mod.psum(mesh, axis))
