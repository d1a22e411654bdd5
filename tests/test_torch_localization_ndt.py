"""Parity of the port's NDT prior-map localization (`localize_ndt`, its loss
gate and `relocalize`) with the JAX package: tests/test_localization_io.py's
room as a stencil-baked NDT target and a raw point map, both built once by
the JAX package and carried over with `convert`. JAX's `localize_ndt` runs
compiled. Tolerances as in test_torch_localization.py (`_compare`).
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pointcloud_slam_tpu import ops as jops, register as jreg
from pointcloud_slam_tpu.geom import se3 as jse3
from pointcloud_slam_tpu.models.localization import pipeline as jloc
from pointcloud_slam_tpu_torch import convert, ops as tops
from pointcloud_slam_tpu_torch.geom import se3 as tse3
from pointcloud_slam_tpu_torch.io import synthetic as tsyn
from pointcloud_slam_tpu_torch.models.localization import pipeline as tloc
from test_torch_localization import _compare, _np

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def room():
    """tests/test_localization_io.py's NDT case: a 6,000-point room as a
    baked NDT target and a raw point map, built by JAX and carried over."""
    world = tsyn.make_room_cloud(6000, seed=0)
    cfg_j = jloc.LocalizationConfig(method="ndt")
    ndt_cfg_j, ndt_j = jreg.ndt.build_target(cfg_j.ndt, jnp.asarray(world.T), baked=True)
    pt_kw = dict(capacity=1 << 14, pts_per_voxel=8, resolution=1.0, nearby=7)
    pt_cfg_j = jops.GridConfig(**pt_kw)
    pt_j = jops.insert(pt_cfg_j, jops.create(pt_cfg_j), jnp.asarray(world.T), jnp.ones(len(world), bool))
    ndt_cfg_t = tops.GridConfig(**dataclasses.asdict(ndt_cfg_j))
    ndt_t = convert.baked_gaussian_map_from_numpy(_np(ndt_j), "cpu")
    pt_t = convert.grid_from_numpy(_np(pt_j), "cpu")
    R, t = tsyn.random_pose(seed=1, rot_scale=0.03, trans_scale=0.2)
    scan = np.ascontiguousarray(((world[:2000] - t) @ R).astype(np.float32).T)
    return ((cfg_j, ndt_cfg_j, ndt_j, pt_cfg_j, pt_j),
            (tloc.LocalizationConfig(method="ndt"), ndt_cfg_t, ndt_t, tops.GridConfig(**pt_kw), pt_t), scan, R, t)


def _ndt(room, scan):
    (cfg_j, ndt_cfg_j, ndt_j, pt_cfg_j, pt_j), (cfg_t, ndt_cfg_t, ndt_t, pt_cfg_t, pt_t), _, _, _ = room
    res_j = jloc.localize_ndt(cfg_j, ndt_cfg_j, ndt_j, pt_cfg_j, pt_j, jnp.asarray(scan),
                              jnp.ones(scan.shape[1], bool), jse3.identity())
    res_t = tloc.localize_ndt(cfg_t, ndt_cfg_t, ndt_t, pt_cfg_t, pt_t, torch.from_numpy(scan),
                              torch.ones(scan.shape[1], dtype=torch.bool), tse3.identity())
    return res_j, res_t


def test_localize_ndt_matches_jax(room):
    scan, t = room[2], room[4]
    rj, rt = _compare(*_ndt(room, scan))
    assert not bool(rt.lost) and np.linalg.norm(rt.pose.t - t) < 0.1
    assert float(rt.max_eigen) > 0.0


def test_ndt_loss_and_relocalize_match_jax(room):
    """A scan 200 m off the map is lost on both sides; relocalize takes the
    fallback pose on loss and keeps the matched pose otherwise, also when
    fed the JAX result carried over."""
    scan, R, t = room[2], room[3], room[4]
    res_j, res_t = _ndt(room, scan + np.array([[200.0], [0.0], [0.0]], np.float32))
    rj, rt = _compare(res_j, res_t)
    assert bool(rt.lost)
    fb_t = tse3.Pose(torch.from_numpy(R), torch.from_numpy(t))
    p_t = tloc.relocalize(res_t, fb_t)
    p_j = jloc.relocalize(res_j, jse3.Pose(jnp.asarray(R), jnp.asarray(t)))
    np.testing.assert_array_equal(p_t.t.numpy(), np.asarray(p_j.t))
    np.testing.assert_array_equal(p_t.R.numpy(), np.asarray(p_j.R))
    kept = tloc.relocalize(convert.localization_result_from_numpy(
        rj._replace(lost=np.asarray(False)), "cpu"), fb_t)
    np.testing.assert_array_equal(kept.t.numpy(), rj.pose.t)
