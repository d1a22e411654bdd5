"""Core data-structure ops: voxel-hash map, downsampling, exact k-NN (K1)."""

from . import bf_knn
from .downsample import compact, voxel_downsample, voxel_downsample_compact
from .voxel_grid import (
    GridConfig, VoxelHashMap, create, insert, knn, lookup, num_voxels,
    point_to_voxel, stencil_offsets,
)

__all__ = [
    "bf_knn",
    "GridConfig",
    "VoxelHashMap",
    "create",
    "insert",
    "knn",
    "lookup",
    "num_voxels",
    "point_to_voxel",
    "stencil_offsets",
    "voxel_downsample",
    "voxel_downsample_compact",
    "compact",
]
