"""State carried between the JAX package and the port, through numpy.

`*_from_numpy` take the JAX package's NamedTuples with their leaves already
numpy arrays (for example `jax.tree.map(np.asarray, state)`) — any object
with the same field names will do — and build the port's on `device` (the
GPU unless the caller says otherwise). Besides LIO state they carry
registration targets: a GICP target (voxel map + flat covariance
attributes) and plain or stencil-baked Gaussian voxel maps, so that both
sides can align against the same target; and SLAM state: preintegrated IMU
factors, pose graphs and whole `SLAMState`s, so that both packages can
start from one populated state; localization results; and map products:
2-D occupancy grids, 3-D hash occupancy maps (uint32 fingerprints as
int64) and dense occupancy volumes (uint32 hit counts as int32).
`to_numpy` goes back: the port's NamedTuples with numpy leaves in the JAX
package's dtypes (fingerprint rows back to uint32, host flags and counters
back to 0-d arrays), so both sides' states compare leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from .geom.se3 import Pose
from .maps.occupancy import OccupancyGrid
from .maps.pcd2map import OccupancyVolume
from .maps.tiled import VoxelOccupancy3D
from .models.lio import state as st
from .models.lio.pipeline import LIOFrame, LIOState
from .models.lio.preintegration import PreintegratedImu
from .models.liosam.backend import PoseGraph
from .models.liosam.slam import SLAMState
from .models.localization.pipeline import LocalizationResult
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


def preintegrated_from_numpy(p, device="cuda") -> PreintegratedImu:
    return PreintegratedImu(*(_t(getattr(p, f), device) for f in PreintegratedImu._fields))


def pose_graph_from_numpy(g, device="cuda") -> PoseGraph:
    return PoseGraph(*(preintegrated_from_numpy(g.imu_pim, device) if f == "imu_pim" else _t(getattr(g, f), device)
                       for f in PoseGraph._fields))


def slam_state_from_numpy(s, device="cuda") -> SLAMState:
    """A JAX `SLAMState` with numpy leaves (pose graph, voxel maps, keyframe
    stores, counters) as the port's."""
    fields = dict(graph=pose_graph_from_numpy(s.graph, device), corner_map=grid_from_numpy(s.corner_map, device),
                  surf_map=grid_from_numpy(s.surf_map, device), pose=Pose(_t(s.pose.R, device), _t(s.pose.t, device)))
    return SLAMState(**{f: fields[f] if f in fields else _t(getattr(s, f), device) for f in SLAMState._fields})


def localization_result_from_numpy(r, device="cuda") -> LocalizationResult:
    """A JAX `LocalizationResult` with numpy leaves as the port's."""
    return LocalizationResult(Pose(_t(r.pose.R, device), _t(r.pose.t, device)),
                              *(_t(getattr(r, f), device) for f in LocalizationResult._fields[1:]))


def occupancy_grid_from_numpy(g, device="cuda") -> OccupancyGrid:
    return OccupancyGrid(logodds=_t(g.logodds, device))


def voxel_occ3d_from_numpy(m, device="cuda") -> VoxelOccupancy3D:
    """A JAX `VoxelOccupancy3D` (uint32 fingerprints) as the port's (int64)."""
    return _map_from_numpy(VoxelOccupancy3D, m, device)


def occupancy_volume_from_numpy(v, device="cuda") -> OccupancyVolume:
    """A JAX `OccupancyVolume` (uint32 hit counts) as the port's (int32)."""
    return OccupancyVolume(hits=_t(np.asarray(v.hits).astype(np.int32), device))


def to_numpy(obj):
    """The port's state (LIOState, SLAMState, PoseGraph, VoxelHashMap,
    Gaussian maps, map products, NavState, LIOFrame or any NamedTuple of
    tensors) as the same NamedTuple with numpy leaves in the JAX package's
    dtypes."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, OccupancyVolume):
        return OccupancyVolume(hits=to_numpy(obj.hits).astype(np.uint32))
    if isinstance(obj, (VoxelHashMap, GaussianVoxelMap, BakedGaussianMap, VoxelOccupancy3D)):
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
