"""Parity of the port's NDT (`pointcloud_slam_tpu_torch.register.ndt`) and
RBF source covariances (`register.vgicp.source_covariances_rbf`) with the
JAX package, on the same numpy inputs.

Alignments run against the same target: the JAX-built Gaussian map carried
over by `convert` (plain and stencil-baked). Tolerances: poses within
1e-4 m / 0.01 deg, score and largest Hessian eigenvalue at rtol 1e-3,
iteration counts equal (the two sides sum the normal equations in another
order). The port's own target build lands within 1e-3 m of JAX's align.
Voxel statistics are compared at the same voxel coordinates, never slot by
slot (means atol 1e-5, covariances at 1e-4 of the largest entry).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pointcloud_slam_tpu import register as jreg
from pointcloud_slam_tpu.geom import se3 as jse3
from pointcloud_slam_tpu_torch import convert, ops as tops, register as treg
from pointcloud_slam_tpu_torch.geom import se3 as tse3
from pointcloud_slam_tpu_torch.io import synthetic as tsyn

torch.set_num_threads(2)

# the loop-verification config of slam.SLAMConfig (15 iterations)
J_CFG = jreg.NDTConfig(solver=jreg.SolverConfig(max_iterations=15))
T_CFG = treg.NDTConfig(solver=treg.SolverConfig(max_iterations=15))


# the port's grid configs of the JAX targets below (capacity 1 << 13; baked 4x)
T_GC = tops.GridConfig(capacity=1 << 13, resolution=1.0, nearby=7)
T_BC = tops.GridConfig(capacity=1 << 15, resolution=1.0, nearby=7)


def _pair(seed, n=4000, rot=0.04, trans=0.3):
    """tests/test_registration.py::make_pair as (3, N) arrays."""
    world = tsyn.make_room_cloud(n, seed=seed)
    R, t = tsyn.random_pose(seed=seed + 1, rot_scale=rot, trans_scale=trans)
    return np.ascontiguousarray(world.T), np.ascontiguousarray(((world - t) @ R).astype(np.float32).T), R, t


def _np_tree(tree):
    return type(tree)(*(np.asarray(v) for v in tree))


def _pose_close(pt, pj, tol_m=1e-4, tol_deg=0.01):
    Rt, Rj = np.asarray(pt.R, np.float64), np.asarray(pj.R, np.float64)
    dt = float(np.linalg.norm(np.asarray(pt.t) - np.asarray(pj.t)))
    A = Rj.T @ Rt
    s = 0.5 * np.array([A[2, 1] - A[1, 2], A[0, 2] - A[2, 0], A[1, 0] - A[0, 1]])
    deg = float(np.degrees(np.arcsin(min(np.linalg.norm(s), 1.0))))
    assert dt < tol_m and deg < tol_deg, (dt, deg)


def _result_close(rt, rj, tol_m=1e-4):
    _pose_close(rt.pose, rj.pose, tol_m=tol_m)
    assert int(rt.iterations) == int(rj.iterations)
    assert bool(rt.converged) == bool(rj.converged)
    np.testing.assert_allclose(float(rt.score), float(rj.score), rtol=1e-3)
    np.testing.assert_allclose(float(rt.max_eigen), float(rj.max_eigen), rtol=1e-3)


@pytest.fixture(scope="module")
def pair():
    return _pair(seed=0)


@pytest.fixture(scope="module")
def jax_targets(pair):
    """JAX-built plain and baked targets (capacity 1 << 13) as numpy."""
    world = jnp.asarray(pair[0])
    gc, g = jreg.ndt.build_target(J_CFG, world, capacity=1 << 13)
    bc, b = jreg.ndt.build_target(J_CFG, world, capacity=1 << 13, baked=True)
    return (gc, _np_tree(g)), (bc, _np_tree(b))


def test_gauss_coeffs_match_jax():
    """(d1, d2) are host floats computed by the same formula: equal."""
    for kw in ({}, dict(resolution=0.5, outlier_ratio=0.3), dict(resolution=2.0)):
        assert treg.NDTConfig(**kw).gauss_coeffs() == jreg.NDTConfig(**kw).gauss_coeffs()


@pytest.mark.parametrize("baked", [False, True])
def test_align_matches_jax(pair, jax_targets, baked):
    """P2D align on the same target (JAX's map carried over), from identity."""
    _, src, _, _ = pair
    (gc, g), (bc, b) = jax_targets
    jcfg, jt = (bc, b) if baked else (gc, g)
    tt = convert.baked_gaussian_map_from_numpy(b, "cpu") if baked else convert.gaussian_map_from_numpy(g, "cpu")
    rj = jreg.ndt.align(jcfg, jax.tree.map(jnp.asarray, jt), jnp.asarray(src), cfg=J_CFG)
    rt = treg.ndt.align(T_BC if baked else T_GC, tt, torch.from_numpy(src), cfg=T_CFG)
    _result_close(rt, rj)


def test_correspond_matches_jax(pair, jax_targets):
    """Unbaked (one probe + gathers) and baked correspondences against JAX's
    rolled-table and baked ones: validity equal, statistics where valid."""
    world, _, _, _ = pair
    (gc, g), (bc, b) = jax_targets
    pw, mask = world[:, :600], np.arange(600) % 7 != 0
    outs_j = [jreg.ndt._correspond(J_CFG, gc, jax.tree.map(jnp.asarray, g), jnp.asarray(pw), jnp.asarray(mask)),
              jreg.ndt._correspond_baked(J_CFG, bc, jax.tree.map(jnp.asarray, b), jnp.asarray(pw), jnp.asarray(mask))]
    outs_t = [treg.ndt._correspond(T_CFG, T_GC, convert.gaussian_map_from_numpy(g, "cpu"), torch.from_numpy(pw),
                                   torch.from_numpy(mask)),
              treg.ndt._correspond_baked(T_CFG, T_BC, convert.baked_gaussian_map_from_numpy(b, "cpu"),
                                         torch.from_numpy(pw), torch.from_numpy(mask))]
    for (mj, ij, vj), (mt, it, vt) in zip(outs_j, outs_t):
        vj = np.asarray(vj)
        np.testing.assert_array_equal(vt.numpy(), vj)
        assert vj.sum() > 150
        np.testing.assert_allclose(mt.numpy()[:, vj], np.asarray(mj)[:, vj], atol=1e-6)
        np.testing.assert_allclose(it.numpy()[:, vj], np.asarray(ij)[:, vj], atol=1e-5)
        assert not mt.numpy()[:, ~vj].any() and not it.numpy()[:, ~vj].any()


def test_own_target_align_matches_jax(pair):
    """Build and align entirely on each side: the port's own target (moments
    summed in another order) lands within 1e-3 m of JAX's align."""
    world, src, R, t = pair
    jgc, jg = jreg.ndt.build_target(J_CFG, jnp.asarray(world))
    rj = jreg.ndt.align(jgc, jg, jnp.asarray(src), cfg=J_CFG)
    tgc, tg = treg.ndt.build_target(T_CFG, torch.from_numpy(world))
    rt = treg.ndt.align(tgc, tg, torch.from_numpy(src), cfg=T_CFG)
    _pose_close(rt.pose, rj.pose, tol_m=1e-3, tol_deg=0.05)
    assert float(np.linalg.norm(rt.pose.t.numpy() - t)) < 0.1


def test_align_d2d_matches_jax(jax_targets):
    """D2D on the same baked target from the same source voxels (JAX's
    voxelize_source), with an initial pose; then the port's unbaked target
    must give the port's baked result (1e-4 m / 0.01 deg), as in JAX's own
    test. (JAX's D2D costs ~10 s of compilation per target kind, so the
    unbaked kind is held to the baked one on the port's side only.)"""
    _, src, _, _ = _pair(seed=9)
    (gc, g), (bc, b) = jax_targets
    jsrc = jreg.ndt.voxelize_source(J_CFG, jnp.asarray(src))
    tsrc = [torch.from_numpy(np.array(a)) for a in jsrc[:3]]
    init_R = np.asarray(tsyn.random_pose(seed=3, rot_scale=0.01, trans_scale=0.05)[0])
    jinit = jse3.Pose(jnp.asarray(init_R), jnp.asarray([0.02, -0.01, 0.0], jnp.float32))
    tinit = tse3.Pose(torch.from_numpy(init_R), torch.tensor([0.02, -0.01, 0.0]))
    rj = jreg.ndt.align_d2d(bc, jax.tree.map(jnp.asarray, b), *jsrc[:3], init_pose=jinit, cfg=J_CFG)
    rt = treg.ndt.align_d2d(T_BC, convert.baked_gaussian_map_from_numpy(b, "cpu"), *tsrc, init_pose=tinit, cfg=T_CFG)
    _result_close(rt, rj)
    ru = treg.ndt.align_d2d(T_GC, convert.gaussian_map_from_numpy(g, "cpu"), *tsrc, init_pose=tinit, cfg=T_CFG)
    _result_close(ru, rt)


def _by_voxel(means, valid, res=1.0):
    """Valid voxel means keyed and sorted by their voxel coordinate."""
    m = np.asarray(means)[:, np.asarray(valid)]
    key = np.floor(m / res).astype(np.int64)
    order = np.lexsort(key[::-1])
    return key[:, order], m[:, order]


def _fixed_build(monkeypatch, cloud):
    """Build the source's Gaussian map once and make voxelize_source use that
    map: a map's slot layout may differ between two builds (claim races), so
    the compaction is checked against the very map it compacted."""
    gcfg = tops.GridConfig(capacity=1 << 14, resolution=1.0, nearby=1)
    g = tops.gaussian_grid.build(gcfg, cloud, torch.ones(cloud.shape[1], dtype=torch.bool), mode="ndt",
                                 min_points=T_CFG.min_points_per_voxel)
    monkeypatch.setattr(treg.ndt.gg, "build", lambda *args, **kwargs: g)
    return g, torch.nonzero(g.valid)[:, 0]


def test_voxelize_source_matches_jax_and_keeps_slot_order(pair, monkeypatch):
    """Compacted source voxels: the same voxels and statistics as JAX (means
    at 1e-5), valid ones first, in slot order (the stable sort that stands
    for JAX's top_k on the valid flag)."""
    _, src, _, _ = pair
    jm, jc, jv, jn = jreg.ndt.voxelize_source(J_CFG, jnp.asarray(src))
    tm, tc, tv, tn = treg.ndt.voxelize_source(T_CFG, torch.from_numpy(src))
    assert tm.shape == (3, 1 << 13) and int(tv.sum()) == int(np.asarray(jv).sum()) > 50
    nv = int(tv.sum())
    assert bool(tv[:nv].all()) and not bool(tv[nv:].any())
    kj, mj = _by_voxel(jm, jv)
    kt, mt = _by_voxel(tm.numpy(), tv.numpy())
    np.testing.assert_array_equal(kt, kj)
    np.testing.assert_allclose(mt, mj, atol=1e-5)
    g, slots = _fixed_build(monkeypatch, torch.from_numpy(src))
    tm, tc, tv, tn = treg.ndt.voxelize_source(T_CFG, torch.from_numpy(src))
    np.testing.assert_array_equal(tm[:, :nv].numpy(), g.mean[:, slots].numpy())
    np.testing.assert_array_equal(tc[:, :nv].numpy(), g.cov[:, slots].numpy())
    np.testing.assert_array_equal(tn[:nv].numpy(), g.count[slots].numpy())


def test_voxelize_source_truncates_past_compact_to(pair, monkeypatch):
    """The known reference defect (ROADMAP §3): past `compact_to` valid
    voxels the rest are dropped silently — the port keeps the first
    `compact_to` valid slots, as JAX's top_k does, and raises nothing."""
    world, _, _, _ = pair
    jm, jc, jv, jn = jreg.ndt.voxelize_source(J_CFG, jnp.asarray(world), compact_to=64)
    assert bool(np.asarray(jv).all()) and np.isfinite(np.asarray(jm)).all()
    g, slots = _fixed_build(monkeypatch, torch.from_numpy(world))
    tm, tc, tv, tn = treg.ndt.voxelize_source(T_CFG, torch.from_numpy(world), compact_to=64)
    assert len(slots) > 64                                 # more valid voxels than kept
    assert tm.shape == (3, 64) and bool(tv.all())
    np.testing.assert_array_equal(tm.numpy(), g.mean[:, slots[:64]].numpy())


def test_rbf_covariances_match_jax():
    """source_covariances_rbf from the same points (a quarter masked out).
    The blended moments are summed in another order, and E[pp^T] - mu mu^T
    in f32 at coordinates up to 10 m (|p|^2 ~ 100) cancels ~4 digits: every
    entry within 1e-3, 99.5 % within 4e-5 (1e-4 of the largest entry)."""
    world = tsyn.make_room_cloud(6000, seed=7)
    pts = np.ascontiguousarray(world.T)
    mask = np.arange(pts.shape[1]) % 4 != 0
    cj = np.asarray(jreg.source_covariances_rbf(jnp.asarray(pts), jnp.asarray(mask), resolution=0.8,
                                                kernel_width=0.4))
    ct = treg.source_covariances_rbf(torch.from_numpy(pts), torch.from_numpy(mask), resolution=0.8,
                                     kernel_width=0.4).numpy()
    assert np.isfinite(ct).all()
    err = np.abs(ct - cj)
    assert err.max() < 1e-3, err.max()
    assert np.mean(err <= 1e-4 * float(np.abs(cj).max())) >= 0.995

