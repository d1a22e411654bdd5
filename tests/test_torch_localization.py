"""Parity of the port's prior-map localization
(`pointcloud_slam_tpu_torch.models.localization`) with the JAX package, on
the same numpy inputs and the same prior maps: each map is built once by
the JAX package and carried over with `convert`, so both sides match
against the same slots.

JAX's `localize_loam` runs op by op (`jax.disable_jit()`; compiling it
costs about two minutes), at one shape for every case of this file (64
corner and 256 surface points, 2 GN iterations) on one stencil-baked grid
of 7 points a voxel: op by op, JAX compiles each indexing primitive once
per static index, so the points a voxel set this file's time (~15 s of
compiling at 7). `localize_ndt` is in test_torch_localization_ndt.py.
Tolerances (`_compare`): pose 1e-3 m / 1e-3 rad, fitness rtol 1e-3,
matched fraction within 0.005, lost and degenerate equal, max eigenvalue
rtol 1e-3. Also: the configuration defaults and
`localization_config_from_params` against the JAX package's.
"""

import dataclasses
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pointcloud_slam_tpu import ops as jops, register as jreg
from pointcloud_slam_tpu.geom import se3 as jse3
from pointcloud_slam_tpu.models.liosam import params as jparams, scan2map as js2m
from pointcloud_slam_tpu.models.localization import pipeline as jloc
from pointcloud_slam_tpu.utils import config as cfgio
from pointcloud_slam_tpu_torch import convert, ops as tops, register as treg
from pointcloud_slam_tpu_torch.geom import se3 as tse3, so3 as tso3
from pointcloud_slam_tpu_torch.models.liosam import params as tparams, scan2map as ts2m
from pointcloud_slam_tpu_torch.models.localization import pipeline as tloc

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# stencil-baked (one lookup a k-NN query), the layout of the localization
# app's feature maps
GRID_KW = dict(capacity=1 << 13, pts_per_voxel=7, resolution=0.6, nearby=7, baked=True)
GRID_J, GRID_T = jops.GridConfig(**GRID_KW), tops.GridConfig(**GRID_KW)
S2M_KW = dict(max_iterations=2, degeneracy_threshold=100.0)
CFG_J = jloc.LocalizationConfig(method="loam", scan2map=js2m.Scan2MapConfig(
    corner_grid=GRID_J, surf_grid=GRID_J, degeneracy_eig=1.0, solver=jreg.SolverConfig(**S2M_KW)))
CFG_T = tloc.LocalizationConfig(method="loam", scan2map=ts2m.Scan2MapConfig(
    corner_grid=GRID_T, surf_grid=GRID_T, degeneracy_eig=1.0, solver=treg.SolverConfig(**S2M_KW)))
NC, NS = 64, 256


def _np(tree):
    return type(tree)(*(np.asarray(v) for v in tree))


def _world(seed=0, half=10.0, floor_noise=0.02):
    """tests/test_feature_localization.py's world: a ground plane (surface
    family) and 25 vertical poles (corner family)."""
    rng = np.random.default_rng(seed)
    floor = np.concatenate([rng.uniform(-half, half, (6000, 2)),
                            floor_noise * rng.standard_normal((6000, 1))], 1).astype(np.float32)
    poles = []
    for _ in range(25):
        px, py = rng.uniform(-half * 0.8, half * 0.8, 2)
        z = np.linspace(0.0, 3.0, 40)[:, None]
        poles.append(np.concatenate([np.full((40, 1), px), np.full((40, 1), py), z], 1))
    return np.concatenate(poles).astype(np.float32), floor


def _channel(world, t, n, seed):
    """A sensor-frame scan channel (3, n): world points seen from (I, t)."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(world), min(n, len(world)), replace=False)
    out = np.zeros((n, 3), np.float32)
    m = np.zeros(n, bool)
    out[: len(idx)] = world[idx] - t
    m[: len(idx)] = True
    return np.ascontiguousarray(out.T), m


def _map_j(cloud):
    return jops.insert(GRID_J, jops.create(GRID_J), jnp.asarray(cloud.T), jnp.ones(len(cloud), bool))


def _compare(res_j, res_t):
    rj = jax.tree.map(np.asarray, res_j)
    rt = convert.to_numpy(res_t)
    np.testing.assert_allclose(rt.pose.t, rj.pose.t, atol=1e-3)
    rot = tso3.log(torch.from_numpy(rt.pose.R.T @ rj.pose.R))
    assert float(rot.norm()) < 1e-3
    np.testing.assert_allclose(rt.fitness, rj.fitness, rtol=1e-3)
    assert abs(float(rt.matched_frac) - float(rj.matched_frac)) <= 0.005
    assert bool(rt.lost) == bool(rj.lost)
    assert bool(rt.degenerate) == bool(rj.degenerate)
    np.testing.assert_allclose(rt.max_eigen, rj.max_eigen, rtol=1e-3)
    return rj, rt


@pytest.fixture(scope="module")
def yard():
    """The poles-and-floor world's corner and surface maps (JAX, and carried
    over to the port) and the scan seen from t_true."""
    corners, floor = _world()
    maps_j = (_map_j(corners), _map_j(floor))
    maps_t = tuple(convert.grid_from_numpy(_np(m), "cpu") for m in maps_j)
    t_true = np.array([1.2, -0.8, 1.5], np.float32)
    return maps_j, maps_t, _channel(corners, t_true, NC, 1), _channel(floor, t_true, NS, 2), t_true


def _loam(maps_j, maps_t, c, cm, s, sm, t0):
    init_j = jse3.Pose(jnp.eye(3), jnp.asarray(t0))
    init_t = tse3.Pose(torch.eye(3), torch.from_numpy(t0))
    with jax.disable_jit():
        res_j = jloc.localize_loam(CFG_J, None, *maps_j, jnp.asarray(c), jnp.asarray(cm), jnp.asarray(s),
                                   jnp.asarray(sm), init_j)
    res_t = tloc.localize_loam(CFG_T, None, *maps_t, torch.from_numpy(c), torch.from_numpy(cm),
                               torch.from_numpy(s), torch.from_numpy(sm), init_t)
    return res_j, res_t


@pytest.mark.parametrize("corner_channel", ["both", "empty"])
def test_localize_loam_matches_jax(yard, corner_channel):
    """Both feature channels, and the empty corner channel of
    run_localization's raw-tile LOAM mode, from a horizontally offset guess."""
    maps_j, maps_t, (c, cm), (s, sm), t_true = yard
    if corner_channel == "empty":
        c, cm = np.zeros_like(c), np.zeros_like(cm)
    t0 = t_true + np.array([0.3, 0.2, 0.1], np.float32)
    rj, rt = _compare(*_loam(maps_j, maps_t, c, cm, s, sm, t0))
    assert float(rt.max_eigen) == 0.0
    assert 0.0 < float(rt.matched_frac) <= 1.0 and np.isfinite(rt.fitness)


def test_localize_loam_degenerate_surf_only_world():
    """An exact plane and no corner channel: x, y and yaw are unobservable,
    and both packages raise the degeneracy flag (the LMOptimization guard)."""
    corners, floor = _world(seed=3, floor_noise=0.0)
    maps_j = (jops.create(GRID_J), _map_j(floor))
    maps_t = tuple(convert.grid_from_numpy(_np(m), "cpu") for m in maps_j)
    t_true = np.array([0.0, 0.0, 1.5], np.float32)
    s, sm = _channel(floor, t_true, NS, 4)
    c, cm = np.zeros((3, NC), np.float32), np.zeros(NC, bool)
    rj, rt = _compare(*_loam(maps_j, maps_t, c, cm, s, sm, t_true))
    assert bool(rt.degenerate) and bool(rj.degenerate)


def test_config_defaults_match_jax():
    assert dataclasses.asdict(tloc.LocalizationConfig()) == dataclasses.asdict(jloc.LocalizationConfig())


@pytest.mark.parametrize("name", ["rslidar.yaml", "params_2.yaml"])
def test_localization_config_from_params_matches_jax(name):
    y = cfgio.load_yaml(os.path.join(ROOT, "configs", "slam", name))
    cfg_j, tiles_j = jparams.localization_config_from_params(y)
    cfg_t, tiles_t = tparams.localization_config_from_params(y)
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    assert tiles_t == tiles_j
    if name == "rslidar.yaml":
        assert cfg_t.method == "ndt" and cfg_t.ndt.resolution == 0.5 and tiles_t["unused"] == []
