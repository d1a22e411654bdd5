"""Multi-device parallelism on torch.distributed: the (dp, sp) mesh, the
rank launcher and the sharded registration, LIO, scan-to-map and backend
solves (port of `pointcloud_slam_tpu/parallel/`)."""

from .mesh import launch, make_mesh
from .sharded_backend import sharded_optimize
from .sharded_icp import sharded_point_to_plane_icp
from .sharded_lio import sharded_lio_update
from .sharded_scan2map import sharded_scan_to_map

__all__ = ["make_mesh", "sharded_point_to_plane_icp", "sharded_optimize",
           "sharded_lio_update", "sharded_scan_to_map", "launch"]
