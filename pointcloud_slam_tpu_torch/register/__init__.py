"""Registration: shared GN/LM SE(3) solver, point-to-plane ICP, (V)GICP.
NDT and `source_covariances_rbf` are not ported yet."""

from . import gicp, icp, solver, vgicp
from .gicp import GICPConfig, GICPResult
from .icp import ICPConfig, ICPResult, batched_point_to_plane_icp, build_target_map, fitness_score, point_to_plane_icp
from .solver import SolveResult, SolverConfig, gauss_newton, levenberg_marquardt
from .vgicp import VGICPConfig, VGICPResult, source_covariances

__all__ = [
    "icp",
    "vgicp",
    "gicp",
    "solver",
    "VGICPConfig",
    "VGICPResult",
    "GICPConfig",
    "GICPResult",
    "source_covariances",
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
