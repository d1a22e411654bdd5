"""Core data-structure ops: voxel-hash map, Gaussian voxel map,
downsampling, exact k-NN and 1-NN (kernels K1, K2)."""

from . import bf_knn, gaussian_grid
from .downsample import compact, voxel_downsample, voxel_downsample_compact
from .voxel_grid import (
    GridConfig, VoxelHashMap, create, insert, knn, lookup, num_voxels,
    point_to_voxel, stencil_offsets,
)

__all__ = [
    "bf_knn",
    "gaussian_grid",
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
