"""pointcloud_slam_tpu_torch — the PyTorch/CUDA port of `pointcloud_slam_tpu`.

Same module layout, names and structure-of-arrays layouts as the JAX
package (clouds (3, N), voxel blocks (3, K, C), k-NN outputs (k, N)), so a
reader finds each counterpart by path. Functions take tensors and work on
the tensors' device; state is NamedTuples, as in the JAX package. Hand-written
CUDA kernels live in `csrc/` and are built with nvcc at first use
(`ops/_cuda.py`); every kernel has a plain PyTorch version beside it that
CPU tensors take.

This package imports torch and numpy only, never jax.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry/estimation math needs true float32 accumulation (the JAX package
# pins jax_default_matmul_precision="highest" for the same reason): TF32
# keeps ~3 decimal digits, and chained 3x3 rotation products and
# normal-equation solves would drift.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from . import geom, io, maps, models, ops, register, utils  # noqa: E402

__all__ = ["geom", "ops", "register", "models", "maps", "io", "utils"]
