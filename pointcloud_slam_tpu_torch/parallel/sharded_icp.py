"""Point-axis-sharded scan-to-map registration over a device mesh (port of
`pointcloud_slam_tpu/parallel/sharded_icp.py`).

The reference's per-point parallelism (`std::execution::par_unseq` in
laser_mapping.cc:606-698, OpenMP in ndt_omp / fast_gicp) across ranks: a
frame's point axis is sharded on `sp`, each rank finds its shard's
correspondences in the replicated voxel map and linearizes them, and an
all-reduce of (H, b, err) over `sp` lets every rank apply the same 6-DoF
update. A leading batch of independent problems shards on `dp`.
"""

from __future__ import annotations

import torch

from .. import ops
from ..geom import se3
from ..register import icp as icp_mod
from . import mesh as mesh_mod


def sharded_point_to_plane_icp(mesh, grid_cfg: ops.GridConfig, grid: ops.VoxelHashMap, source: torch.Tensor,
                               source_mask: torch.Tensor, init_pose: se3.Pose,
                               cfg: icp_mod.ICPConfig = icp_mod.ICPConfig()):
    """B scan-to-map alignments against one map held by every rank.

    source (B, 3, N), source_mask (B, N), init_pose of batch B: the same
    global tensors on every rank; B must divide over `dp` and N over `sp`.
    This rank solves its B/dp frames on its N/sp points with the batched
    solver's cached-search schedule. Returns (pose, converged, iterations)
    for all B frames on every rank."""
    src = mesh_mod.shard(mesh_mod.shard(source, mesh, "dp", 0), mesh, "sp", 2).contiguous()
    mask = mesh_mod.shard(mesh_mod.shard(source_mask, mesh, "dp", 0), mesh, "sp", 1).reshape(-1)
    pose0 = se3.Pose(*(mesh_mod.shard(a, mesh, "dp", 0) for a in init_pose))

    def search(pose):
        return icp_mod.correspondences(cfg, grid_cfg, grid, icp_mod._flat(pose.apply(src)), mask)

    pose, done, iters, _, _, _ = icp_mod.icp_loop(cfg, src, pose0, search, reduce=mesh_mod.psum(mesh, "sp"))
    R, t, done, iters = mesh_mod.gather_rows((pose.R, pose.t, done, iters), mesh, "dp")
    return se3.Pose(R, t), done, iters
