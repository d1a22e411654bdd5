"""Map products: 2-D occupancy grids (bounded + tiled large-world), 3-D
occupancy (bounded dense volume + unbounded hash octree-role), nav clouds,
octomap `.bt` files (port of `pointcloud_slam_tpu/maps/`)."""

from . import occupancy, octomap_io, pcd2map, tiled
from .occupancy import OccupancyConfig, OccupancyGrid
from .pcd2map import OccupancyVolume, VolumeConfig
from .tiled import TiledOccupancyMap, VoxelOccConfig, VoxelOccupancy3D

__all__ = [
    "occupancy",
    "octomap_io",
    "pcd2map",
    "tiled",
    "OccupancyConfig",
    "OccupancyGrid",
    "VolumeConfig",
    "OccupancyVolume",
    "TiledOccupancyMap",
    "VoxelOccConfig",
    "VoxelOccupancy3D",
]
