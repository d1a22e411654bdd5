"""Core data-structure ops: voxel-hash map, Gaussian voxel map,
downsampling, the PHC sub-voxel merge, exact k-NN and 1-NN (kernels K1, K2),
small symmetric eigendecompositions (kernel K6)."""

from . import bf_knn, gaussian_grid, phc, small_eigh
from .downsample import compact, random_decimate, voxel_downsample, voxel_downsample_compact
from .phc import hilbert_coords, hilbert_index, phc_merge, phc_sort
from .voxel_grid import (
    GridConfig, VoxelHashMap, create, insert, knn, lookup, num_voxels,
    point_to_voxel, stencil_offsets,
)

__all__ = [
    "bf_knn",
    "small_eigh",
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
    "random_decimate",
    "phc",
    "hilbert_index",
    "hilbert_coords",
    "phc_merge",
    "phc_sort",
]
