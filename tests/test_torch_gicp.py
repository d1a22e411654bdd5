"""Parity of the port's GICP and VGICP (`pointcloud_slam_tpu_torch.register.gicp`,
`.vgicp`) with the JAX package, on the same numpy inputs, and the round trip
of registration targets through `convert`.

Pose tolerances: 1e-3 m and 0.05 deg against JAX aligning on the same target
(a JAX target carried over by `convert`, JAX source covariances), and
against JAX aligning on its own target where each side builds its own. The
normal equations are one contraction here and 21 scalar sums in JAX: they
agree at rtol 1e-4 (`test_weighted_terms_match_jax`).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pointcloud_slam_tpu import ops as jops, register as jreg
from pointcloud_slam_tpu.register import vgicp as jvgicp
from pointcloud_slam_tpu_torch import convert, ops as tops, register as treg
from pointcloud_slam_tpu_torch.io import synthetic as tsyn
from pointcloud_slam_tpu_torch.register import gicp as tgicp, vgicp as tvgicp

torch.set_num_threads(2)


def _pair(seed, n, rot=0.04, trans=0.3):
    """tests/test_registration.py::make_pair."""
    world = tsyn.make_room_cloud(n, seed=seed)
    R, t = tsyn.random_pose(seed=seed + 1, rot_scale=rot, trans_scale=trans)
    return np.ascontiguousarray(world.T), np.ascontiguousarray(((world - t) @ R).astype(np.float32).T), R, t


def _pose_close(pt, pj, tol_m=1e-3, tol_deg=0.05):
    Rt, Rj = np.asarray(pt.R, np.float64), np.asarray(pj.R, np.float64)
    dt = np.linalg.norm(np.asarray(pt.t) - np.asarray(pj.t))
    A = Rj.T @ Rt
    deg = np.degrees(np.arcsin(min(1.0, 0.5 * np.linalg.norm([A[2, 1] - A[1, 2], A[0, 2] - A[2, 0], A[1, 0] - A[0, 1]]))))
    assert dt <= tol_m and deg <= tol_deg, (dt, deg)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_weighted_terms_match_jax(rng):
    """`_offset_terms` (one contraction over stacked Jacobian columns) against
    JAX's 21 scalar reductions on random correspondences: H, b at rtol 1e-4
    of their largest entry, err at rtol 1e-5."""
    S, N = 7, 500
    pw = rng.uniform(-5, 5, size=(3, N)).astype(np.float32)
    ok = rng.uniform(size=(S, N)) < 0.7
    cnt = rng.integers(1, 30, size=(S, N)).astype(np.float32)
    mean = (pw[:, None, :] + rng.normal(scale=0.3, size=(3, S, N))).astype(np.float32)
    A = rng.normal(size=(S, N, 3, 3))
    C = A @ np.swapaxes(A, -1, -2) * 0.01 + 1e-3 * np.eye(3)
    cov6 = np.stack([C[..., 0, 0], C[..., 0, 1], C[..., 0, 2], C[..., 1, 1], C[..., 1, 2], C[..., 2, 2]]).astype(np.float32)
    src6 = cov6[:, 0].copy()
    R = tsyn.random_pose(seed=2, rot_scale=0.3)[0]
    t6j = jvgicp._src_cov_world(jnp.asarray(src6), jnp.asarray(R))
    Hj, bj, ej = jvgicp._offset_terms(jnp.zeros((6, 6)), jnp.zeros(6), jnp.zeros(()), *map(jnp.asarray, pw),
                                      jnp.asarray(ok), jnp.asarray(cnt), *map(jnp.asarray, mean),
                                      [jnp.asarray(c) for c in cov6], t6j)
    t6t = tvgicp._src_cov_world(torch.from_numpy(src6), torch.from_numpy(R))
    Ht, bt, et = tvgicp._offset_terms(torch.from_numpy(pw), torch.from_numpy(ok), torch.from_numpy(cnt),
                                      torch.from_numpy(mean), torch.from_numpy(cov6), t6t)
    for a, b in ((Ht, Hj), (bt, bj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4 * float(np.abs(b).max()))
    np.testing.assert_allclose(float(et), float(ej), rtol=1e-5)


# ---- GICP ----

@pytest.fixture(scope="module", params=[("voxel", 3), ("exact", 8)], ids=["voxel", "exact"])
def gicp_run(request):
    """Targets, source covariances and JAX solves of the 3,000-point
    test_registration GICP pair, for one covariance method. The voxel
    method uses k = 3 covariance neighbours: JAX's unrolled voxel search
    takes ~40 s to compile at k = 8."""
    method, k = request.param
    world, src, R, t = _pair(seed=4, n=3000)
    mask = np.ones(src.shape[1], bool)
    jcfg = jreg.GICPConfig(cov_method=method, k_correspondences=k)
    jtarget = jreg.gicp.build_target(jcfg, jnp.asarray(world))
    jcov = jreg.source_covariances(jnp.asarray(src), jnp.asarray(mask), k=k, resolution=1.0, method=method)
    jres = jreg.gicp.align(*jtarget, jnp.asarray(src), jcov, jnp.asarray(mask), cfg=jcfg)
    tcfg = treg.GICPConfig(cov_method=method, k_correspondences=k)
    ttarget = tgicp.build_target(tcfg, torch.from_numpy(world))
    tcov = treg.source_covariances(torch.from_numpy(src), torch.from_numpy(mask), k=k, resolution=1.0, method=method)
    return dict(world=world, src=src, mask=mask, t=t, jcfg=jcfg, jtarget=jtarget, jcov=jcov, jres=jres,
                tcfg=tcfg, ttarget=ttarget, tcov=tcov)


def test_gicp_target_matches_jax(gicp_run):
    """The targets compared through what they answer: each target point's
    nearest map point is itself on both sides, and the covariance attribute
    joined through that answer agrees at atol 1e-5 (the points kept by the
    K = 8 blocks, ~95 %, are the same on both sides) on all but 0.5 % of the
    points: those whose covariance neighbourhood is decided by a near-tie
    (the two sides then pick sets that differ by one point)."""
    (jgc, jg, jatt), (tgc, tg, tatt) = gicp_run["jtarget"], gicp_run["ttarget"]
    q = gicp_run["world"]
    _, dj, cj, ij = map(np.asarray, jops.knn(jgc, jg, jnp.asarray(q), k=1, max_range=0.5))
    _, dt, ct, it = tops.knn(tgc, tg, torch.from_numpy(q), k=1, max_range=0.5)
    selfj, selft = (cj > 0) & (dj[0] == 0), ((ct > 0) & (dt[0] == 0)).numpy()
    np.testing.assert_array_equal(selft, selfj)
    assert selfj.mean() > 0.9
    diff = np.abs(tatt.numpy()[:, it[0].numpy()[selft]] - np.asarray(jatt)[:, ij[0][selfj]]).max(axis=0)
    assert (diff > 1e-5).mean() < 0.005, np.sort(diff)[-10:]


def test_gicp_align_matches_jax(gicp_run):
    """On JAX's target (carried over) with JAX's source covariances, and each
    side on its own target: poses within 1e-3 m / 0.05 deg of JAX's, final
    error at rtol 1e-3 on the carried target, and within 0.1 m of the truth
    (the gate of tests/test_registration.py)."""
    r = gicp_run
    jres = r["jres"]
    _, jg, jatt = r["jtarget"]
    tg, tatt = convert.voxel_map_from_numpy(_np(jg), np.asarray(jatt), device="cpu")
    src = torch.from_numpy(r["src"])
    mask = torch.from_numpy(r["mask"])
    res = tgicp.align(r["ttarget"][0], tg, tatt, src, torch.from_numpy(np.asarray(r["jcov"])), mask, cfg=r["tcfg"])
    _pose_close(res.pose, jres.pose)
    assert int(res.iterations) == int(jres.iterations) and bool(res.converged) == bool(jres.converged)
    np.testing.assert_allclose(float(res.error), float(jres.error), rtol=1e-3)
    own = tgicp.align(*r["ttarget"], src, r["tcov"], mask, cfg=r["tcfg"])
    _pose_close(own.pose, jres.pose)
    assert np.linalg.norm(own.pose.t.numpy() - r["t"]) < 0.1


# ---- VGICP ----

@pytest.fixture(scope="module")
def vgicp_pair():
    """The test_registration baked/unbaked pair; both sides align with the
    same source covariances (the port's, whose parity test_torch_bf_knn
    holds)."""
    world, src, R, t = _pair(seed=11, n=4000)
    cov = treg.source_covariances(torch.from_numpy(src), torch.ones(src.shape[1], dtype=torch.bool), k=8)
    return world, src, t, cov.numpy()


@pytest.mark.parametrize("baked", [False, True], ids=["unbaked", "baked"])
def test_vgicp_align_matches_jax(vgicp_pair, baked):
    """On JAX's Gaussian map (carried over, plain or stencil-baked) and on the
    port's own: poses within 1e-3 m / 0.05 deg of JAX's, final error at rtol
    1e-3 on the carried target, within 0.1 m of the truth."""
    world, src, t, cov = vgicp_pair
    jcfg, tcfg = jreg.VGICPConfig(resolution=1.0), treg.VGICPConfig(resolution=1.0)
    jgc, jtarget = jreg.vgicp.build_target(jcfg, jnp.asarray(world), capacity=1 << 13, baked=baked)
    jres = jreg.vgicp.align(jgc, jtarget, jnp.asarray(src), jnp.asarray(cov), cfg=jcfg)
    tgc, ttarget = tvgicp.build_target(tcfg, torch.from_numpy(world), capacity=1 << 13, baked=baked)
    carried = (convert.baked_gaussian_map_from_numpy if baked else convert.gaussian_map_from_numpy)(
        _np(jtarget), device="cpu")
    res = tvgicp.align(tgc, carried, torch.from_numpy(src), torch.from_numpy(cov), cfg=tcfg)
    _pose_close(res.pose, jres.pose)
    assert int(res.iterations) == int(jres.iterations)
    np.testing.assert_allclose(float(res.error), float(jres.error), rtol=1e-3)
    own = tvgicp.align(tgc, ttarget, torch.from_numpy(src), torch.from_numpy(cov), cfg=tcfg)
    _pose_close(own.pose, jres.pose)
    assert np.linalg.norm(own.pose.t.numpy() - t) < 0.1


# ---- convert ----

def test_registration_targets_round_trip():
    """JAX GICP target, Gaussian map and baked map -> numpy -> port -> numpy:
    every leaf equal, same dtype (fingerprints use the full uint32 range)."""
    world = tsyn.make_room_cloud(2000, seed=1).T.copy()
    _, jg, jatt = jreg.gicp.build_target(jreg.GICPConfig(cov_method="exact"), jnp.asarray(world), capacity=1 << 12)
    vcfg = jreg.VGICPConfig(resolution=1.0)
    _, jgauss = jreg.vgicp.build_target(vcfg, jnp.asarray(world), capacity=1 << 12)
    _, jbaked = jreg.vgicp.build_target(vcfg, jnp.asarray(world), capacity=1 << 12, baked=True)
    tg, tatt = convert.voxel_map_from_numpy(_np(jg), np.asarray(jatt), device="cpu")
    pairs = [(_np(jg), convert.to_numpy(tg)), (np.asarray(jatt), convert.to_numpy(tatt)),
             (_np(jgauss), convert.to_numpy(convert.gaussian_map_from_numpy(_np(jgauss), device="cpu"))),
             (_np(jbaked), convert.to_numpy(convert.baked_gaussian_map_from_numpy(_np(jbaked), device="cpu")))]
    assert np.asarray(jgauss.fp).max() > 2 ** 31 and np.asarray(jbaked.fp).max() > 2 ** 31
    for a, b in pairs:
        la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
        assert len(la) == len(lb) > 0
        for x, y in zip(la, lb):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
