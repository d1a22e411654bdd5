"""Parity of the port's remaining small functions with the JAX package's, on
the same numpy inputs: `ops.random_decimate`, `geom.fit.eigh3x3` /
`eigh_small` / `eigvalsh_small`, `models.lio.fusion` and
`utils.checkpoint.save_state` / `load_state`.

Tolerances: decimation masks equal; eigh3x3 eigenvalues 1e-4 relative to
the largest and vectors 1e-3 up to sign (float32 closed form, the same
arithmetic on both sides); eigh_small values and vectors 1e-5 relative to
the largest eigenvalue (the same rotations in float32) and its gradient
1e-4; the IMU-rate poses 1e-5 (20 float32 steps); checkpoints exactly.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pointcloud_slam_tpu import ops as jops
from pointcloud_slam_tpu.geom import fit as jfit
from pointcloud_slam_tpu.models import lio as jlio
from pointcloud_slam_tpu.models.lio import fusion as jfusion
from pointcloud_slam_tpu.models.lio import state as jst
from pointcloud_slam_tpu.utils import checkpoint as jck
from pointcloud_slam_tpu_torch import convert, ops as tops
from pointcloud_slam_tpu_torch.geom import fit as tfit
from pointcloud_slam_tpu_torch.models import lio as tlio
from pointcloud_slam_tpu_torch.models.lio import fusion as tfusion
from pointcloud_slam_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("every_n", [1, 3, 4])
def test_random_decimate_matches_jax(rng, every_n):
    pts = rng.normal(size=(3, 500)).astype(np.float32)
    mask = rng.random(500) < 0.7
    pj, kj = jops.random_decimate(jnp.asarray(pts), jnp.asarray(mask), every_n)
    pt, kt = tops.random_decimate(_t(pts), _t(mask), every_n)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(pt.numpy(), pts)
    assert int(kt.sum()) == -(-int(mask.sum()) // every_n)


def test_eigh3x3_matches_jax(rng):
    M = rng.normal(size=(200, 3, 3)).astype(np.float32)
    A = (M @ np.swapaxes(M, 1, 2)).astype(np.float32)
    A[:20] = np.diag([2.0, 2.0, 5.0]).astype(np.float32)                 # repeated eigenvalues
    vj, Vj = (np.asarray(x) for x in jfit.eigh3x3(jnp.asarray(A)))
    vt, Vt = (x.numpy() for x in tfit.eigh3x3(_t(A)))
    scale = np.abs(vj).max(axis=1, keepdims=True)
    np.testing.assert_allclose(vt / scale, vj / scale, atol=1e-4)
    sign = np.sign(np.sum(Vt * Vj, axis=1, keepdims=True))
    distinct = np.min(np.diff(vj, axis=1), axis=1) > 1e-2 * scale[:, 0]
    np.testing.assert_allclose((Vt * sign)[distinct], Vj[distinct], atol=1e-3)
    # columns are eigenvectors: A V = V diag(vals)
    np.testing.assert_allclose(A @ Vt, Vt * vt[:, None, :], atol=2e-3 * scale.max())


def _sym6(rng):
    q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    return ((q * np.array([1e-3, 50.0, 120.0, 3e3, 8e3, 2e4])) @ q.T).astype(np.float32)


@pytest.mark.parametrize("case", ["spread", "repeated"])
def test_eigh_small_matches_jax(rng, case):
    """Values and vectors (up to sign) of the 6x6 spread case of
    tests/test_geom.py and its repeated-eigenvalue diagonal (test_geom.py:206),
    whose vectors must stay orthonormal."""
    A = _sym6(rng) if case == "spread" else np.diag([4.0, 4.0, 1.0, 9.0, 4.0, 0.0]).astype(np.float32)
    vj, Vj = (np.asarray(x) for x in jfit.eigh_small(jnp.asarray(A)))
    vt, Vt = (x.numpy() for x in tfit.eigh_small(_t(A)))
    scale = np.abs(vj).max()
    np.testing.assert_allclose(vt, vj, atol=1e-5 * scale)
    np.testing.assert_allclose(tfit.eigvalsh_small(_t(A)).numpy(), vt, atol=0)
    np.testing.assert_allclose(Vt.T @ Vt, np.eye(6), atol=1e-5)
    if case == "spread":
        sign = np.sign(np.sum(Vt * Vj, axis=0, keepdims=True))
        np.testing.assert_allclose(Vt * sign, Vj, atol=1e-5)
        np.testing.assert_allclose(A @ Vt, Vt * vt[None, :], atol=scale * 1e-3)
    else:
        np.testing.assert_allclose(vt, [0, 1, 4, 4, 4, 9], atol=1e-5)


def test_eigh_small_gradient_matches_jax(rng):
    """d(sum of eigenvalues weighted)/dA through autograd against jax.grad,
    on a random matrix and on the near-diagonal one of test_geom.py:220
    (off-diagonal 1e-12, inside eigh's backward overflow window): finite and
    equal to 1e-4. Two sweeps on both sides (the same rotations, a third of
    the default's; JAX differentiates the default's in ~20 s here)."""
    A = rng.normal(size=(6, 6))
    A = np.asarray(A + A.T, np.float32)
    A_near = np.diag(np.asarray([1.0, 2, 3, 4, 5, 6], np.float32))
    A_near[0, 1] = A_near[1, 0] = 1e-12
    w = np.arange(1, 7, dtype=np.float32)
    grad = jax.jit(jax.grad(lambda m: jnp.sum(jfit.eigh_small(m, sweeps=2)[0] * w)))
    for mat in (A, A_near):
        gj = np.asarray(grad(jnp.asarray(mat)))
        x = _t(mat).requires_grad_(True)
        (gt,) = torch.autograd.grad(torch.sum(tfit.eigh_small(x, sweeps=2)[0] * _t(w)), x)
        assert np.isfinite(gt.numpy()).all()
        np.testing.assert_allclose(gt.numpy(), gj, atol=1e-4)


def _nav(rng):
    x = jst.boxplus(jst.identity(), jnp.asarray(rng.normal(size=23).astype(np.float32) * 0.1))
    return x, convert.nav_state_from_numpy(jax.tree.map(np.asarray, x), device="cpu")


def test_predict_poses_and_fuse_match_jax(rng):
    xj, xt = _nav(rng)
    M = 20
    acc = (rng.normal(size=(M, 3)) * 0.5 + [0, 0, 9.81]).astype(np.float32)
    gyro = (rng.normal(size=(M, 3)) * 0.1).astype(np.float32)
    dt = np.full(M, 0.005, np.float32)
    mask = np.arange(M) < 17
    Rj, pj, vj = (np.asarray(a) for a in jfusion.predict_poses(xj, *map(jnp.asarray, (acc, gyro, dt, mask)), 1.02))
    Rt, pt, vt = (a.numpy() for a in tfusion.predict_poses(xt, *map(_t, (acc, gyro, dt, mask)), 1.02))
    for a, b in ((Rt, Rj), (pt, pj), (vt, vj)):
        np.testing.assert_allclose(a, b, atol=1e-5)
    np.testing.assert_array_equal(Rt[17:], np.broadcast_to(Rt[16], Rt[17:].shape))
    Ro, po, Rn = (np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32) for _ in range(3))
    pn = rng.normal(size=3).astype(np.float32)
    fj = jfusion.fuse_with_update(*map(jnp.asarray, (Rj, pj, Ro, po[0], Rn, pn)))
    ft = tfusion.fuse_with_update(*map(_t, (Rj, pj, Ro, po[0], Rn, pn)))
    for a, b in zip(ft, fj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def _jax_lio_state(rng):
    cfg = jlio.LIOConfig(grid=jops.GridConfig(capacity=1 << 10, pts_per_voxel=4, resolution=0.5, nearby=7))
    s = jlio.create_state(cfg)
    pts = jnp.asarray(rng.uniform(-3, 3, size=(3, 300)).astype(np.float32))
    s = s._replace(x=jst.boxplus(s.x, jnp.asarray(rng.normal(size=23).astype(np.float32) * 0.1)),
                   grid=jops.insert(cfg.grid, s.grid, pts, jnp.ones(300, bool)),
                   initialized=jnp.asarray(True), init_count=jnp.asarray(23, jnp.int32))
    tcfg = tlio.LIOConfig(grid=tops.GridConfig(capacity=1 << 10, pts_per_voxel=4, resolution=0.5, nearby=7))
    return s, tcfg


def test_load_state_reads_a_jax_checkpoint(rng, tmp_path):
    """A LIO state the JAX package's save_state wrote loads into the port equal
    to the same state carried across by convert.py; the port's own file
    round-trips and the JAX package reads it back leaf for leaf."""
    s, tcfg = _jax_lio_state(rng)
    jck.save_state(str(tmp_path / "jax.npz"), s)
    like = tlio.create_state(tcfg, device="cpu")
    loaded = tck.load_state(str(tmp_path / "jax.npz"), like)
    want = convert.lio_state_from_numpy(jax.tree.map(np.asarray, s), device="cpu")
    a, b = convert.to_numpy(loaded), convert.to_numpy(want)
    assert loaded.initialized is True and loaded.init_count == 23
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    tck.save_state(str(tmp_path / "port.npz"), loaded)
    again = tck.load_state(str(tmp_path / "port.npz"), like)
    for x, y in zip(jax.tree.leaves(convert.to_numpy(again)), jax.tree.leaves(a)):
        np.testing.assert_array_equal(x, y)
    back = jck.load_state(str(tmp_path / "port.npz"), s)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(s)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    with pytest.raises(AssertionError, match="leaves"):
        tck.load_state(str(tmp_path / "port.npz"), like.grid)
