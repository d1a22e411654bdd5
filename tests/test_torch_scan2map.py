"""Parity of the port's LOAM scan-to-map matching
(`pointcloud_slam_tpu_torch.models.liosam.scan2map`) and of SLAM loop
verification by ICP (`slam._verify_loop`, the ScanContext channel) with the
JAX package, on
the same numpy inputs and the same maps and keyframes (JAX's, carried over
by `convert`).

The JAX side runs op by op (`jax.disable_jit()`): compiling its
`scan_to_map` costs about a minute, and JAX's compiled `plane_fit` differs
from its own eager ops (ROADMAP §3). Op by op, JAX compiles each primitive
at each new shape once (~20 s here); both tests use the same shapes. Against eager JAX the k-NN answers and
the line fits agree to 2e-5; `plane_fit` solves A n = -1 by adjugates,
which cancels ~3 digits on a small patch far from the sensor, so ~0.1 % of
surface validity flags follow the summation order. With those flags the
pose lands within 1e-3 m / 1e-3 of eager JAX (measured: 2-4e-4 m).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pointcloud_slam_tpu import ops as jops, register as jreg
from pointcloud_slam_tpu.models.liosam import scan2map as js2m
from pointcloud_slam_tpu_torch import convert, ops as tops, register as treg
from pointcloud_slam_tpu_torch.io import synthetic as tsyn
from pointcloud_slam_tpu_torch.models.liosam import scan2map as ts2m

torch.set_num_threads(2)

# 4 iterations: 2 warm-up rounds of one, then a round of 2 (3 searches)
KW = dict(warmup_searches=2, search_every=2)
CFG_J = js2m.Scan2MapConfig(solver=jreg.SolverConfig(max_iterations=4, degeneracy_threshold=100.0), **KW)
CFG_T = ts2m.Scan2MapConfig(solver=treg.SolverConfig(max_iterations=4, degeneracy_threshold=100.0), **KW)


def _np(tree):
    return type(tree)(*(np.asarray(v) for v in tree))


def _t(a):
    return torch.from_numpy(np.array(a))


def _loam_world(rng):
    """tests/test_liosam.py::TestScan2Map's yard: poles (corners) and a floor
    and two walls (surfaces), 4 mm noise."""
    poles = []
    for (px, py) in [(-4, -4), (4, -4), (-4, 4), (4, 4), (0, 4), (4, 0)]:
        z = rng.uniform(0, 3, size=(60, 1))
        poles.append(np.concatenate([np.full((60, 1), float(px)), np.full((60, 1), float(py)), z], axis=1))
    corners = np.concatenate(poles).astype(np.float32) + rng.normal(scale=0.004, size=(360, 3)).astype(np.float32)
    floor = np.concatenate([rng.uniform(-5, 5, size=(1200, 2)), np.zeros((1200, 1))], axis=1)
    wall1 = np.stack([rng.uniform(-5, 5, 800), np.full(800, 5.0), rng.uniform(0, 3, 800)], axis=1)
    wall2 = np.stack([np.full(800, -5.0), rng.uniform(-5, 5, 800), rng.uniform(0, 3, 800)], axis=1)
    surfs = np.concatenate([floor, wall1, wall2]).astype(np.float32)
    return corners, surfs + rng.normal(scale=0.004, size=surfs.shape).astype(np.float32)


@pytest.fixture(scope="module")
def baked():
    """The yard's stencil-baked maps in JAX and carried over to the port, and
    the scan seen from a random pose (sensor frame, (3, N))."""
    cfg_j, cfg_t = CFG_J, CFG_T
    cfg_j = dataclasses.replace(cfg_j, corner_grid=js2m.baked_grid(cfg_j.corner_grid),
                                surf_grid=js2m.baked_grid(cfg_j.surf_grid))
    cfg_t = dataclasses.replace(cfg_t, corner_grid=ts2m.baked_grid(cfg_t.corner_grid),
                                surf_grid=ts2m.baked_grid(cfg_t.surf_grid))
    corners, surfs = _loam_world(np.random.default_rng(0))
    R, t = tsyn.random_pose(seed=3, rot_scale=0.03, trans_scale=0.2)
    cm = jops.insert(cfg_j.corner_grid, jops.create(cfg_j.corner_grid), jnp.asarray(corners.T), jnp.ones(360, bool))
    sm = jops.insert(cfg_j.surf_grid, jops.create(cfg_j.surf_grid), jnp.asarray(surfs.T), jnp.ones(2800, bool))
    src = [np.ascontiguousarray(((w - t) @ R).astype(np.float32).T) for w in (corners, surfs)]
    maps_t = [convert.grid_from_numpy(_np(m), "cpu") for m in (cm, sm)]
    return cfg_j, cfg_t, (cm, sm), maps_t, src, t


def test_rows_match_eager_jax(baked):
    """One search at the scan's own pose: corner rows (line fits) within
    2e-5, at most 0.2 % of surface validity flags apart, surface rows
    within 1e-5 where both sides are valid and their fits agree to 1e-3
    (the ill-conditioned patches excepted, as above)."""
    cfg_j, cfg_t, (cm, sm), (cmt, smt), (csrc, ssrc), _ = baked
    with jax.disable_jit():
        rc_j = js2m._corner_rows(cfg_j, cm, jnp.asarray(csrc), jnp.ones(360, bool))
        rs_j = js2m._surf_rows(cfg_j, sm, jnp.asarray(ssrc), jnp.ones(2800, bool))
    rc_t = ts2m._corner_rows(cfg_t, cmt, _t(csrc), torch.ones(360, dtype=torch.bool))
    rs_t = ts2m._surf_rows(cfg_t, smt, _t(ssrc), torch.ones(2800, dtype=torch.bool))
    np.testing.assert_array_equal(rc_t[5].numpy(), np.asarray(rc_j[5]))
    assert int(rc_t[5].sum()) > 300
    for a, b in zip(rc_t[:5], rc_j[:5]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5)
    ok_t, ok_j = rs_t[5].numpy(), np.asarray(rs_j[5])
    assert np.mean(ok_t != ok_j) <= 0.002 and ok_j.sum() > 2000
    both = ok_t & ok_j
    coef_t = np.stack([a.numpy() for a in rs_t[:4]])
    coef_j = np.stack([np.asarray(b) for b in rs_j[:4]])
    agree = both & (np.abs(coef_t - coef_j).max(axis=0) < 1e-3)
    assert agree.sum() >= 0.995 * both.sum()


def test_scan_to_map_matches_eager_jax(baked):
    """The whole match (search rounds, degeneracy projector per round, GN
    steps, final linearization): pose within 1e-3 m / 1e-3 of eager JAX,
    match counts within 0.2 %, iterations and the degeneracy flag equal;
    the recovered pose within 5 cm of the truth."""
    cfg_j, cfg_t, (cm, sm), (cmt, smt), (csrc, ssrc), t = baked
    with jax.disable_jit():
        rj = js2m.scan_to_map(cfg_j, cm, sm, jnp.asarray(csrc), jnp.ones(360, bool), jnp.asarray(ssrc),
                              jnp.ones(2800, bool))
    rt = ts2m.scan_to_map(cfg_t, cmt, smt, _t(csrc), torch.ones(360, dtype=torch.bool), _t(ssrc),
                          torch.ones(2800, dtype=torch.bool))
    np.testing.assert_allclose(rt.pose.t.numpy(), np.asarray(rj.pose.t), atol=1e-3)
    np.testing.assert_allclose(rt.pose.R.numpy(), np.asarray(rj.pose.R), atol=1e-3)
    assert abs(int(rt.num_surf) - int(rj.num_surf)) <= 0.002 * int(rj.num_surf)
    assert abs(int(rt.num_corner) - int(rj.num_corner)) <= 0.002 * int(rj.num_corner) + 1
    assert bool(rt.degenerate) == bool(rj.degenerate)
    assert int(rt.iterations) == int(rj.iterations)
    assert np.linalg.norm(rt.pose.t.numpy() - t) < 0.05


def test_baked_grid_matches_jax():
    """baked_grid: the same stencil and resolution, nearby x pts_per_voxel
    points a voxel."""
    for g in (CFG_T.corner_grid, CFG_T.surf_grid):
        b = ts2m.baked_grid(g)
        bj = js2m.baked_grid(jops.GridConfig(**{f: getattr(g, f) for f in ("capacity", "pts_per_voxel",
                                                                              "resolution", "nearby")}))
        assert b.baked and b.pts_per_voxel == bj.pts_per_voxel == g.nearby * g.pts_per_voxel
        assert isinstance(b, tops.GridConfig)
