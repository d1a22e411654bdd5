"""LIO-SAM style pipeline: projection, LOAM features, scan-to-map matching,
ScanContext loop closure, pose-graph back-end, the SLAM frame step."""

from . import backend, features, params, projection, scan2map, scancontext, slam
from .backend import BackendConfig, PoseGraph
from .features import FeatureConfig, Features
from .projection import ProjectionConfig, RangeImage
from .scan2map import Scan2MapConfig, Scan2MapResult
from .scancontext import ScanContextConfig
from .slam import SLAMConfig, SLAMOutput, SLAMState, create_state, slam_step

__all__ = [
    "projection",
    "features",
    "scan2map",
    "scancontext",
    "backend",
    "slam",
    "params",
    "ProjectionConfig",
    "RangeImage",
    "FeatureConfig",
    "Features",
    "Scan2MapConfig",
    "Scan2MapResult",
    "ScanContextConfig",
    "BackendConfig",
    "PoseGraph",
    "SLAMConfig",
    "SLAMState",
    "SLAMOutput",
    "create_state",
    "slam_step",
]
