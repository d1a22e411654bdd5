"""Registration: shared GN/LM SE(3) solver, point-to-plane ICP, NDT, (V)GICP."""

from . import gicp, icp, ndt, solver, vgicp
from .gicp import GICPConfig, GICPResult
from .icp import ICPConfig, ICPResult, batched_point_to_plane_icp, build_target_map, fitness_score, point_to_plane_icp
from .ndt import NDTConfig, NDTResult
from .solver import SolveResult, SolverConfig, gauss_newton, levenberg_marquardt
from .vgicp import VGICPConfig, VGICPResult, source_covariances, source_covariances_rbf

__all__ = [
    "icp",
    "ndt",
    "vgicp",
    "gicp",
    "solver",
    "NDTConfig",
    "NDTResult",
    "VGICPConfig",
    "VGICPResult",
    "GICPConfig",
    "GICPResult",
    "source_covariances",
    "source_covariances_rbf",
    "ICPConfig",
    "ICPResult",
    "point_to_plane_icp",
    "batched_point_to_plane_icp",
    "build_target_map",
    "fitness_score",
    "SolverConfig",
    "SolveResult",
    "gauss_newton",
    "levenberg_marquardt",
]
