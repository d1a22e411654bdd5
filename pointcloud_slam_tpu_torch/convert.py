"""State carried between the JAX package and the port, through numpy.

`*_from_numpy` take the JAX package's NamedTuples with their leaves already
numpy arrays (for example `jax.tree.map(np.asarray, state)`) — any object
with the same field names will do — and build the port's on `device`.
`to_numpy` goes back: the port's NamedTuples with numpy leaves in the JAX
package's dtypes (the fingerprint row back to uint32, host flags and
counters back to 0-d arrays), so both sides can compute on the same map and
their states compare leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.lio import state as st
from .models.lio.pipeline import LIOFrame, LIOState
from .ops.voxel_grid import VoxelHashMap


def _t(a, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def nav_state_from_numpy(x, device="cpu") -> st.NavState:
    return st.NavState(*(_t(getattr(x, f), device) for f in st.NavState._fields))


def grid_from_numpy(g, device="cpu") -> VoxelHashMap:
    return VoxelHashMap(
        keys=_t(g.keys, device, torch.int32),
        fp=_t(np.asarray(g.fp).astype(np.int64), device),
        occupied=_t(g.occupied, device, torch.bool),
        pts=_t(g.pts, device),
        npts=_t(g.npts, device, torch.int32),
        stamp=_t(g.stamp, device, torch.int32),
        counter=_t(g.counter, device, torch.int32),
    )


def frame_from_numpy(f, device="cpu") -> LIOFrame:
    return LIOFrame(*(_t(getattr(f, name), device) for name in LIOFrame._fields))


def lio_state_from_numpy(tree, device="cpu") -> LIOState:
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
    """The port's state (LIOState, VoxelHashMap, NavState, LIOFrame or any
    NamedTuple of tensors) as the same NamedTuple with numpy leaves in the
    JAX package's dtypes."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, VoxelHashMap):
        out = VoxelHashMap(*(to_numpy(v) for v in obj))
        return out._replace(fp=out.fp.astype(np.uint32))
    if isinstance(obj, LIOState):
        out = LIOState(*(to_numpy(v) for v in obj))
        return out._replace(initialized=np.asarray(obj.initialized, bool),
                            first_scan=np.asarray(obj.first_scan, bool),
                            init_count=np.asarray(obj.init_count, np.int32))
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_numpy(v) for v in obj))
    return obj
