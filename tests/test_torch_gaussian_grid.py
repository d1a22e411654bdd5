"""Parity of the port's Gaussian voxel map (`pointcloud_slam_tpu_torch.ops.gaussian_grid`)
with the JAX package's, on the same numpy points. Maps are compared at the
same voxel coordinates (each side probes its own table), never slot by slot.

Tolerances: counts and validity equal; means at atol 1e-5; covariances and
inverse covariances at atol 1e-4 of each map's largest entry (moments are
summed in another order: index_add_ against XLA's scatter-add, and the
covariance is E[pp^T] - mu mu^T, which cancels digits).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pointcloud_slam_tpu import ops as jops
from pointcloud_slam_tpu.ops import gaussian_grid as jgg
from pointcloud_slam_tpu_torch import ops as tops, register as treg
from pointcloud_slam_tpu_torch.ops import gaussian_grid as tgg
from pointcloud_slam_tpu_torch.register import vgicp as tvgicp

torch.set_num_threads(2)

CFG = dict(capacity=1 << 12, resolution=1.0, nearby=7)


def _points(rng, n=4000):
    return rng.uniform(-4, 4, size=(3, n)).astype(np.float32)


def _voxels(pts, res=1.0):
    """Unique voxel coords (3, V) of a cloud, int32."""
    return np.unique(np.floor(pts / res).astype(np.int32), axis=1)


def _at(g, slots, field):
    return np.asarray(getattr(g, field))[..., np.asarray(slots)]


def _close_scaled(a, b, rel=1e-4):
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * float(np.abs(b).max()))


@pytest.mark.parametrize("mode", ["ndt", "plane"])
def test_build_matches_jax(rng, mode):
    """build (accumulate + finalize) from the same masked points: every voxel
    holds the same count, validity and statistics on both sides."""
    pts = _points(rng)
    mask = rng.uniform(size=pts.shape[1]) < 0.9
    jg = jgg.build(jops.GridConfig(**CFG), jnp.asarray(pts), jnp.asarray(mask), mode=mode, min_points=6)
    tcfg = tops.GridConfig(**CFG)
    tg = tgg.build(tcfg, torch.from_numpy(pts), torch.from_numpy(mask), mode=mode, min_points=6)
    vox = _voxels(pts[:, mask])
    sj = np.asarray(jgg.probe(jops.GridConfig(**CFG), jg, tuple(jnp.asarray(v) for v in vox)))
    st = tgg.probe(tcfg, tg, tuple(torch.from_numpy(v) for v in vox)).numpy()
    assert (sj >= 0).all() and (st >= 0).all()
    assert int(tg.occupied.sum()) == int(np.asarray(jg.occupied).sum()) == vox.shape[1]
    np.testing.assert_array_equal(_at(tg, st, "count"), _at(jg, sj, "count"))
    np.testing.assert_array_equal(_at(tg, st, "valid"), _at(jg, sj, "valid"))
    np.testing.assert_array_equal(_at(tg, st, "keys"), vox)
    valid = _at(jg, sj, "valid")
    assert 0.3 < valid.mean() < 0.9   # both gated and kept voxels occur
    np.testing.assert_allclose(_at(tg, st, "mean"), _at(jg, sj, "mean"), rtol=0, atol=1e-5)
    for field in ("cov", "icov"):
        _close_scaled(_at(tg, st, field)[:, valid], _at(jg, sj, field)[:, valid])


def test_accumulate_in_two_batches(rng):
    """Moments accumulated over two batches equal one batch of all points,
    and match JAX's two-batch accumulation."""
    pts = _points(rng, 1600)
    tcfg, jcfg = tops.GridConfig(**CFG), jops.GridConfig(**CFG)
    ones = np.ones(800, bool)
    tg = tgg.create(tcfg, device="cpu")
    jg = jgg.create(jcfg)
    for part in (pts[:, :800], pts[:, 800:]):
        tg = tgg.accumulate(tcfg, tg, torch.from_numpy(np.ascontiguousarray(part)), torch.from_numpy(ones))
        jg = jgg.accumulate(jcfg, jg, jnp.asarray(part), jnp.asarray(ones))
    one = tgg.accumulate(tcfg, tgg.create(tcfg, device="cpu"), torch.from_numpy(pts), torch.ones(1600, dtype=torch.bool))
    vox = _voxels(pts)
    st = tgg.probe(tcfg, tg, tuple(torch.from_numpy(v) for v in vox)).numpy()
    so = tgg.probe(tcfg, one, tuple(torch.from_numpy(v) for v in vox)).numpy()
    sj = np.asarray(jgg.probe(jcfg, jg, tuple(jnp.asarray(v) for v in vox)))
    for field in ("count", "sum", "sq"):
        np.testing.assert_allclose(_at(tg, st, field), _at(one, so, field), rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(_at(tg, st, field), _at(jg, sj, field), rtol=1e-6, atol=1e-5)


def test_probe_absent_voxel(rng):
    tcfg = tops.GridConfig(**CFG)
    tg = tgg.build(tcfg, torch.from_numpy(_points(rng)), torch.ones(4000, dtype=torch.bool))
    far = torch.full((4,), 999, dtype=torch.int32)
    assert bool((tgg.probe(tcfg, tg, (far, far, far)) == -1).all())


def test_bake_matches_jax(rng):
    """Each side bakes its own finalized map; queried at every voxel the
    stencil covers (occupied voxels, their face neighbours and empty ones),
    the baked entries, counts, covariances and found flags agree, and no
    entry was dropped. The baked answer equals the unbaked per-offset probe."""
    pts = _points(rng)
    mask = np.ones(pts.shape[1], bool)
    jcfg, tcfg = jops.GridConfig(**CFG), tops.GridConfig(**CFG)
    bcfg_kw = dict(CFG, capacity=1 << 14)
    jbcfg, tbcfg = jops.GridConfig(**bcfg_kw), tops.GridConfig(**bcfg_kw)
    jg = jgg.build(jcfg, jnp.asarray(pts), jnp.asarray(mask), mode="plane", min_points=4)
    tg = tgg.build(tcfg, torch.from_numpy(pts), torch.from_numpy(mask), mode="plane", min_points=4)
    jb, tb = jgg.bake(jcfg, jg, jbcfg), tgg.bake(tcfg, tg, tbcfg)
    assert int(tb.dropped) == int(jb.dropped) == 0
    vox = _voxels(pts)
    q = np.concatenate([vox + np.asarray(o, np.int32)[:, None] for o in tops.stencil_offsets(7)] +
                       [np.full((3, 5), 40, np.int32)], axis=1)
    q = np.unique(q, axis=1)
    rows_j = jnp.concatenate([jb.entries, jb.counts[:, None, :], jb.covs], axis=1)
    rows_t = torch.cat([tb.entries, tb.counts[:, None, :], tb.covs], dim=1)
    ej, fj = map(np.asarray, jgg.baked_probe(jbcfg, jb, jnp.asarray(q), rows_j))
    et, ft = tgg.baked_probe(tbcfg, tb, torch.from_numpy(q), rows_t)
    et, ft = et.numpy(), ft.numpy()
    np.testing.assert_array_equal(ft, fj)
    assert 0.5 < ft.mean() < 1.0
    hit_t, hit_j = et[..., ft], ej[..., fj]                  # (a miss gathers another slot)
    np.testing.assert_array_equal(hit_t[:, 0], hit_j[:, 0])      # valid flags
    np.testing.assert_array_equal(hit_t[:, 10], hit_j[:, 10])    # counts
    np.testing.assert_allclose(hit_t[:, 1:4], hit_j[:, 1:4], rtol=0, atol=1e-5)
    for rows in (slice(4, 10), slice(11, 17)):                  # icov, cov
        _close_scaled(hit_t[:, rows], hit_j[:, rows])
    # the baked entry for offset s is the unbaked voxel at q + offset s
    offs = tops.stencil_offsets(7)
    for s in (0, 3):
        cc = torch.from_numpy(q + offs[s][:, None])
        slot = tgg.probe(tcfg, tg, (cc[0], cc[1], cc[2]))
        ok = (slot >= 0) & tg.valid[slot.clamp(min=0)]
        np.testing.assert_array_equal((et[s, 0] > 0.5) & ft, ok.numpy())
        np.testing.assert_array_equal(et[s, 1:4][:, ok.numpy()], tg.mean[:, slot[ok]].numpy())


def test_undersized_bake_warns():
    """tests/test_registration.py::TestBakeOverflow: a baked table too small
    for the map surfaces its dropped entries as a warning."""
    from pointcloud_slam_tpu_torch.io import synthetic

    world = torch.from_numpy(synthetic.make_room_cloud(8000, seed=2).T.copy())
    with pytest.warns(UserWarning, match="dropped"):
        tvgicp.build_target(treg.VGICPConfig(resolution=0.5), world, capacity=1 << 12, baked=True,
                            baked_capacity=1 << 6)
