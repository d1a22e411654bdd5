"""State carried between the JAX package and the port, through numpy.

`*_from_numpy` take the JAX package's NamedTuples with their leaves already
numpy arrays (for example `jax.tree.map(np.asarray, state)`) — any object
with the same field names will do — and build the port's on `device` (the
GPU unless the caller says otherwise). Besides LIO state they carry
registration targets: a GICP target (voxel map + flat covariance
attributes) and plain or stencil-baked Gaussian voxel maps, so that both
sides can align against the same target. `to_numpy` goes back: the port's
NamedTuples with numpy leaves in the JAX package's dtypes (fingerprint rows
back to uint32, host flags and counters back to 0-d arrays), so both sides'
states compare leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.lio import state as st
from .models.lio.pipeline import LIOFrame, LIOState
from .ops.gaussian_grid import BakedGaussianMap, GaussianVoxelMap
from .ops.voxel_grid import VoxelHashMap


def _t(a, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def nav_state_from_numpy(x, device="cuda") -> st.NavState:
    return st.NavState(*(_t(getattr(x, f), device) for f in st.NavState._fields))


def grid_from_numpy(g, device="cuda") -> VoxelHashMap:
    return VoxelHashMap(
        keys=_t(g.keys, device, torch.int32),
        fp=_t(np.asarray(g.fp).astype(np.int64), device),
        occupied=_t(g.occupied, device, torch.bool),
        pts=_t(g.pts, device),
        npts=_t(g.npts, device, torch.int32),
        stamp=_t(g.stamp, device, torch.int32),
        counter=_t(g.counter, device, torch.int32),
    )


def voxel_map_from_numpy(g, att, device="cuda"):
    """A GICP target: the voxel map and its flat (6, K*C) per-point
    covariance attributes (`gicp.build_target`'s last two outputs)."""
    return grid_from_numpy(g, device), _t(att, device)


def _map_from_numpy(cls, g, device):
    """A map NamedTuple whose uint32 fingerprint row `fp` is held as int64."""
    return cls(*(_t(np.asarray(g.fp).astype(np.int64) if f == "fp" else getattr(g, f), device) for f in cls._fields))


def gaussian_map_from_numpy(g, device="cuda") -> GaussianVoxelMap:
    return _map_from_numpy(GaussianVoxelMap, g, device)


def baked_gaussian_map_from_numpy(b, device="cuda") -> BakedGaussianMap:
    return _map_from_numpy(BakedGaussianMap, b, device)


def frame_from_numpy(f, device="cuda") -> LIOFrame:
    return LIOFrame(*(_t(getattr(f, name), device) for name in LIOFrame._fields))


def lio_state_from_numpy(tree, device="cuda") -> LIOState:
    return LIOState(
        x=nav_state_from_numpy(tree.x, device),
        P=_t(tree.P, device),
        grid=grid_from_numpy(tree.grid, device),
        initialized=bool(tree.initialized),
        first_scan=bool(tree.first_scan),
        init_count=int(tree.init_count),
        acc_sum=_t(tree.acc_sum, device),
        gyro_sum=_t(tree.gyro_sum, device),
        acc_scale=_t(tree.acc_scale, device),
        prev_acc_w=_t(tree.prev_acc_w, device),
        prev_gyro=_t(tree.prev_gyro, device),
    )


def to_numpy(obj):
    """The port's state (LIOState, VoxelHashMap, Gaussian maps, NavState,
    LIOFrame or any NamedTuple of tensors) as the same NamedTuple with numpy
    leaves in the JAX package's dtypes."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, (VoxelHashMap, GaussianVoxelMap, BakedGaussianMap)):
        out = type(obj)(*(to_numpy(v) for v in obj))
        return out._replace(fp=out.fp.astype(np.uint32))
    if isinstance(obj, LIOState):
        out = LIOState(*(to_numpy(v) for v in obj))
        return out._replace(initialized=np.asarray(obj.initialized, bool),
                            first_scan=np.asarray(obj.first_scan, bool),
                            init_count=np.asarray(obj.init_count, np.int32))
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_numpy(v) for v in obj))
    return obj
