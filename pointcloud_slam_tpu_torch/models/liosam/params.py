"""ParamServer: the reference's flat rosparam names -> typed configs (port of
`pointcloud_slam_tpu/models/liosam/params.py::slam_config_from_params`).

Reference: `src/jueying_slam/include/utility.h:62-332` (ParamServer reads ~70
params under the `jueying_slam:` namespace); the shipped per-pipeline YAMLs
(`config/rslidar.yaml`, `config/hesai.yaml`) use exactly these names.
Recognized keys map onto ProjectionConfig / FeatureConfig / Scan2MapConfig /
SLAMConfig / BackendConfig / ScanContextConfig; unknown keys are collected
and reported. `localization_config_from_params` does the same for the
`globalmap_server:` section (localization.cpp's param block). Host-side
Python only.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from ... import ops
from ...register import ndt as ndt_mod
from ...register import solver as solver_mod
from . import backend as bk
from . import features as feat
from . import projection as proj
from . import scan2map as s2m
from . import scancontext as sc
from . import slam as slam_mod


def _get(params: Dict[str, Any], used: set, key: str, default=None):
    if key in params:
        used.add(key)
        return params[key]
    return default


def slam_config_from_params(params: Dict[str, Any]) -> Tuple["slam_mod.SLAMConfig", "proj.ProjectionConfig", "feat.FeatureConfig", Dict[str, Any]]:
    """Build (SLAMConfig, ProjectionConfig, FeatureConfig, info) from the
    reference's flat `jueying_slam:` param dict.

    `info` carries the params with no in-graph counterpart (topics, frames,
    CPU threading, save paths) plus `unused` — recognized-namespace keys this
    mapping does not consume — so callers can log them.
    """
    p = dict(params.get("jueying_slam", params))
    used: set = set()

    # --- projection (imageProjection role) ---
    n_scan = int(_get(p, used, "N_SCAN", 16))
    vertical = float(_get(p, used, "Vertical_angle", 30.0))
    ang_bottom = float(_get(p, used, "ang_bottom", 15.0))
    pcfg = proj.ProjectionConfig(
        n_scan=n_scan,
        horizon=int(_get(p, used, "Horizon_SCAN", 1800)),
        fov_up_deg=vertical - ang_bottom,
        fov_down_deg=-ang_bottom,
        min_range=float(_get(p, used, "min_range", _get(p, used, "lidarMinRange", 1.0))),
        max_range=float(_get(p, used, "max_range", _get(p, used, "lidarMaxRange", 1000.0))),
    )

    # --- features (featureExtraction role) ---
    fcfg = feat.FeatureConfig(
        edge_threshold=float(_get(p, used, "edgeThreshold", 1.0)),
        surf_threshold=float(_get(p, used, "surfThreshold", 0.1)),
        n_sectors=int(_get(p, used, "area_num", 6)),
    )

    # --- scan-to-map (mapOptimization role) ---
    corner_leaf = float(_get(p, used, "mappingCornerLeafSize", 0.2))
    surf_leaf = float(_get(p, used, "mappingSurfLeafSize", 0.4))
    s2m_cfg = s2m.Scan2MapConfig(
        corner_grid=ops.GridConfig(capacity=1 << 15, pts_per_voxel=8, resolution=2 * corner_leaf, nearby=7),
        surf_grid=ops.GridConfig(capacity=1 << 16, pts_per_voxel=8, resolution=2 * surf_leaf, nearby=7),
        solver=solver_mod.SolverConfig(
            max_iterations=int(_get(p, used, "iter_num", 30)), degeneracy_threshold=100.0
        ),
    )

    # --- backend + keyframing + GPS gating ---
    bcfg = bk.BackendConfig(
        keyframe_dist_thresh=float(_get(p, used, "surroundingkeyframeAddingDistThreshold", 1.0)),
        keyframe_angle_thresh=float(_get(p, used, "surroundingkeyframeAddingAngleThreshold", 0.2)),
    )

    # --- loop closure ---
    loop_enabled = bool(_get(p, used, "loopClosureEnableFlag", True))
    sc_cfg = sc.ScanContextConfig()

    cfg = slam_mod.SLAMConfig(
        backend=bcfg,
        scancontext=sc_cfg,
        scan2map=s2m_cfg,
        loop_fitness_thresh=float(_get(p, used, "historyKeyframeFitnessScore", 0.3)),
        local_window=int(_get(p, used, "surroundingKeyframeSize", 16)),
        rs_loop=loop_enabled,
        rs_radius=float(_get(p, used, "historyKeyframeSearchRadius", 10.0)),
        rs_time_gate=float(_get(p, used, "historyKeyframeSearchTimeDiff", 30.0)),
        gps_cov_thresh=float(_get(p, used, "gpsCovThreshold", 2.0)),
        use_gps_elevation=bool(_get(p, used, "useGpsElevation", False)),
    )

    # --- IMU noise (imuPreintegration role; consumed by callers feeding
    # preintegration factors) ---
    imu = {
        "acc_noise": float(_get(p, used, "imuAccNoise", 0.01)),
        "gyr_noise": float(_get(p, used, "imuGyrNoise", 0.001)),
        "acc_bias_noise": float(_get(p, used, "imuAccBiasN", 1e-4)),
        "gyr_bias_noise": float(_get(p, used, "imuGyrBiasN", 1e-5)),
        "gravity": float(_get(p, used, "imuGravity", 9.81)),
        "frequency": float(_get(p, used, "imuFrequency", 200.0)),
    }
    ext_t = _get(p, used, "extrinsicTrans", [0.0, 0.0, 0.0])
    ext_rot = _get(p, used, "extrinsicRot", [1, 0, 0, 0, 1, 0, 0, 0, 1])
    ext_rpy = _get(p, used, "extrinsicRPY", ext_rot)

    # host-side / out-of-graph params, reported for the caller
    passthrough_keys = [
        "pointCloudTopic", "imuTopic", "odomTopic", "gpsTopic",
        "lidarFrame", "baselinkFrame", "odometryFrame", "mapFrame",
        "savePCD", "savePCDDirectory", "numberOfCores",
        "mappingProcessInterval", "loopClosureFrequency",
        "downsampleRate", "timeField", "lidar_type",
        "odometrySurfLeafSize", "surroundingKeyframeDensity",
        "surroundingKeyframeSearchRadius", "historyKeyframeSearchNum",
        "useImuHeadingInitialization", "poseCovThreshold",
        "z_tollerance", "rotation_tollerance",
        "edgeFeatureMinValidNum", "surfFeatureMinValidNum", "distance_limit",
    ]
    host = {k: _get(p, used, k) for k in passthrough_keys if k in p}

    info = {
        "imu": imu,
        "extrinsic_trans": [float(v) for v in ext_t],
        "extrinsic_rot": [float(v) for v in ext_rot],
        "extrinsic_rpy": [float(v) for v in ext_rpy],
        "loop_closure_enabled": loop_enabled,
        "host": host,
        "unused": sorted(k for k in p if k not in used),
    }
    return cfg, pcfg, fcfg, info


def localization_config_from_params(params: Dict[str, Any]):
    """Build a LocalizationConfig + tile-map settings from the
    `globalmap_server:` section (localization.cpp's param block)."""
    from ..localization import pipeline as loc

    g = dict(params.get("globalmap_server", params))
    used: set = set()
    method = str(_get(g, used, "Matching_method", "ndt"))
    ndt_res = float(_get(g, used, "ndt_resolution", 1.0))
    cfg = loc.LocalizationConfig(method=method, ndt=ndt_mod.NDTConfig(resolution=ndt_res))
    tiles = {
        "surf_map_dir": _get(g, used, "globalSurfMap_dirctory", ""),
        "surf_map_csv": _get(g, used, "globalSurfMap_pcd", ""),
        "corner_map_dir": _get(g, used, "globalCornerMap_dirctory", ""),
        "corner_map_csv": _get(g, used, "globalCornerMap_pcd", ""),
        "area_size": float(_get(g, used, "area_size", 50.0)),
        "margin": float(_get(g, used, "margin", 100.0)),
        "update_map_frequency": float(_get(g, used, "updateMapFrequency", 10.0)),
        "initial_method": _get(g, used, "intialMethod", "human"),
        "initial_pose": [float(v) for v in _get(g, used, "initialPose", [0.0, 0.0, 0.0])],
        "optimization_with_gps": bool(_get(g, used, "optimization_with_GPS", False)),
        "initial_count_num": int(_get(g, used, "initial_count_num", 5)),
        "unused": sorted(k for k in g if k not in used),
    }
    return cfg, tiles
