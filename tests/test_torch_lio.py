"""Parity of the port's LIO modules (`pointcloud_slam_tpu_torch.models.lio`)
with the JAX package's, and of the slice as a whole: the frame step over a
synthetic sequence.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import pointcloud_slam_tpu as J
from pointcloud_slam_tpu.io import synthetic as jsyn
from pointcloud_slam_tpu.models import lio as jlio
from pointcloud_slam_tpu.models.lio import eskf as jeskf, imu as jimu, pipeline as jpipe, state as jst
from pointcloud_slam_tpu_torch import convert, ops as tops
from pointcloud_slam_tpu_torch.io import synthetic as tsyn
from pointcloud_slam_tpu_torch.models import lio as tlio
from pointcloud_slam_tpu_torch.models.lio import eskf as teskf, imu as timu, pipeline as tpipe, state as tst

torch.set_num_threads(2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# jitted once: eager JAX dispatch of the scans costs more than compiling them
_j_propagate = jax.jit(jimu.propagate)
_j_propagate_sequential = jax.jit(jimu.propagate_sequential)


def _imu_inputs(rng, M, n_masked=0):
    """As tests/test_lio.py::TestPropagateParallel: a perturbed state, random
    IMU samples, and LARGE offsets on masked (padding) samples."""
    x = jst.boxplus(jst.identity(), jnp.asarray(rng.normal(scale=0.3, size=23).astype(np.float32)))
    P = jeskf.init_P() * jnp.asarray(rng.uniform(0.5, 2.0), jnp.float32)
    acc = rng.normal(scale=1.0, size=(M, 3)).astype(np.float32) + np.array([0, 0, 9.809], np.float32)
    gyro = rng.normal(scale=0.5, size=(M, 3)).astype(np.float32)
    dts = rng.uniform(0.004, 0.006, size=M).astype(np.float32)
    offs = np.cumsum(dts).astype(np.float32)
    mask = np.ones(M, bool)
    if n_masked:
        mask[-n_masked:] = False
        offs[-n_masked:] = 1e6
    prev_acc = rng.normal(size=3).astype(np.float32)
    prev_gyro = rng.normal(size=3).astype(np.float32)
    return _np(x), np.asarray(P), acc, gyro, dts, offs, mask, np.float32(1.02), prev_acc, prev_gyro


def _jax_args(a):
    x, P, *rest = a
    return (jst.NavState(*map(jnp.asarray, x)), jnp.asarray(P), jeskf.process_noise_cov(), *map(jnp.asarray, rest))


def _torch_args(a):
    x, P, *rest = a
    return (convert.nav_state_from_numpy(x, device="cpu"), torch.from_numpy(np.array(P)), teskf.process_noise_cov(),
            *(torch.from_numpy(np.array(v)) for v in rest))


@pytest.mark.parametrize("n_masked", [0, 7])
def test_propagate_matches_jax(rng, n_masked):
    """One propagation against both JAX `propagate` and `propagate_sequential`
    (tolerances of tests/test_lio.py: 2e-4 on the state, 5e-4 on P — f32
    reassociation of the scans), valid pose-table rows only."""
    a = _imu_inputs(rng, 20, n_masked)
    xt, Pt, tt = timu.propagate(*_torch_args(a))
    valid = np.concatenate([[True], a[6]])
    for name, jfn in (("parallel", _j_propagate), ("sequential", _j_propagate_sequential)):
        xj, Pj, tj = jfn(*_jax_args(a))
        dx = tst.boxminus(xt, convert.nav_state_from_numpy(_np(xj), device="cpu"))
        np.testing.assert_allclose(dx.numpy(), 0.0, atol=2e-4, err_msg=name)
        np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), atol=5e-4, err_msg=name)
        for field in tj._fields:
            np.testing.assert_allclose(getattr(tt, field).numpy()[valid], np.asarray(getattr(tj, field))[valid],
                                       atol=2e-4, err_msg=f"{name} {field}")
    # the port's own sequential oracle against the JAX one
    xs, Ps, _ = timu.propagate_sequential(*_torch_args(a))
    xj, Pj, _ = _j_propagate_sequential(*_jax_args(a))
    np.testing.assert_allclose(tst.boxminus(xs, convert.nav_state_from_numpy(_np(xj), device="cpu")).numpy(), 0.0, atol=2e-4)
    np.testing.assert_allclose(Ps.numpy(), np.asarray(Pj), atol=5e-4)


def test_undistort_matches_jax(rng):
    """Undistortion on the same carried-over pose table and end state:
    atol 1e-4 on points up to 10 m (f32, same formulas)."""
    a = _imu_inputs(rng, 20, 3)
    xj, _, tj = _j_propagate(*_jax_args(a))
    pts = rng.uniform(-10, 10, size=(3, 500)).astype(np.float32)
    t_offs = rng.uniform(0, 0.1, size=500).astype(np.float32)
    mask = rng.uniform(size=500) < 0.9
    oj = jimu.undistort(jnp.asarray(pts), jnp.asarray(t_offs), jnp.asarray(mask), tj, xj)
    tt = timu.PoseTable(*(torch.from_numpy(np.array(v)) for v in _np(tj)))
    ot = timu.undistort(torch.from_numpy(pts), torch.from_numpy(t_offs), torch.from_numpy(mask), tt,
                        convert.nav_state_from_numpy(_np(xj), device="cpu"))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-4)


def test_init_from_measurements_matches_jax(rng):
    acc, gyro = rng.normal(size=3).astype(np.float32) + [0, 0, 9.7], rng.normal(size=3).astype(np.float32)
    gj = jimu.init_from_measurements(jnp.asarray(acc, jnp.float32), jnp.asarray(gyro))
    gt = timu.init_from_measurements(torch.tensor(acc, dtype=torch.float32), torch.from_numpy(gyro))
    for a, b in zip(gj, gt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)


# ---- the slice: LIO frame steps on a synthetic sequence ----

GRID = dict(capacity=1 << 15, pts_per_voxel=8, resolution=0.4, nearby=7, claim_rounds=2)
CFG = dict(scan_leaf=0.3, map_leaf=0.3, init_imu_frames=2, scan_budget=10240, insert_budget=10240,
           max_iterations=3, research_on_converge=False)
N_FRAMES, N_PTS = 15, 3000


def _cfgs(**kw):
    return (jlio.LIOConfig(grid=J.ops.GridConfig(**GRID), **{**CFG, **kw}),
            tlio.LIOConfig(grid=tops.GridConfig(**GRID), **{**CFG, **kw}))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX frame step over the sequence: numpy states before each frame,
    frames, positions and ground truth."""
    jcfg, _ = _cfgs()
    _, _, frames = jsyn.simulate_lio_sequence(n_frames=N_FRAMES, n_pts=N_PTS)
    step = jax.jit(lambda s, f: jlio.lio_step(jcfg, s, f))
    s = jlio.create_state(jcfg)
    states, pos = [], []
    for fr, _, _ in frames:
        states.append(_np(s))
        s, out = step(s, fr)
        pos.append(np.asarray(out.pos))
    gt = np.array([g for _, g, _ in frames]) - frames[0][1]
    return dict(states=states, frames=[_np(f) for f, _, _ in frames], pos=np.array(pos), gt=gt)


def _ate(pos, gt):
    """tests/test_lio.py:227-235: error from frame 5 on (after init)."""
    e = np.linalg.norm(pos[5:] - gt[5:], axis=1)
    return e[-1], e.mean()


def test_slice_tracks_like_jax(jax_run):
    """The slice as a whole. Both implementations pass the ATE gates of
    tests/test_lio.py:233-235. Started each frame from the JAX state (carried
    over by convert), the port's step lands within 1 cm of the JAX step.
    Run freely, the two trajectories stay within 3 cm: f32 sum order and
    same-batch insert races make the two maps differ slightly, and the
    difference compounds through the map."""
    _, tcfg = _cfgs()
    final, mean = _ate(jax_run["pos"], jax_run["gt"])
    assert final < 0.25 and mean < 0.2, (final, mean)
    step_err = []
    for k, (st_np, fr_np) in enumerate(zip(jax_run["states"], jax_run["frames"])):
        _, out = tlio.lio_step(tcfg, convert.lio_state_from_numpy(st_np, device="cpu"),
                               convert.frame_from_numpy(fr_np, device="cpu"))
        step_err.append(np.abs(out.pos.numpy() - jax_run["pos"][k]).max())
    assert max(step_err) < 0.01, np.round(step_err, 4)

    _, _, frames = tsyn.simulate_lio_sequence(n_frames=N_FRAMES, n_pts=N_PTS, device="cpu")
    s = tlio.create_state(tcfg, device="cpu")
    pos = []
    for fr, _, _ in frames:
        s, out = tlio.lio_step(tcfg, s, fr)
        pos.append(out.pos.numpy())
    pos = np.array(pos)
    final, mean = _ate(pos, jax_run["gt"])
    assert final < 0.25 and mean < 0.2, (final, mean)
    assert np.abs(pos - jax_run["pos"]).max() < 0.03


def _plane_obs(lib, pb, nrm, off):
    """A smooth point-to-plane observation model written once per framework
    (fixed correspondences, no validity thresholds), so the update's algebra
    and control flow are compared without the plane-fit validity flips that
    rounding can cause at the 0.1 m threshold."""
    where, stack, zeros = (jnp.where, jnp.stack, jnp.zeros_like) if lib is jnp else (torch.where, torch.stack, torch.zeros_like)

    def obs(x, do_search, cache):
        p_imu = x.ext_R @ pb + x.ext_t[:, None]
        pw = x.rot @ p_imu + x.pos[:, None]
        h = -(nrm[0] * pw[0] + nrm[1] * pw[1] + nrm[2] * pw[2] + off)
        c = x.rot.T @ nrm                                   # R^T n
        a = stack([p_imu[1] * c[2] - p_imu[2] * c[1], p_imu[2] * c[0] - p_imu[0] * c[2],
                   p_imu[0] * c[1] - p_imu[1] * c[0]])
        z = zeros(h)
        h_x = stack([nrm[0], nrm[1], nrm[2], a[0], a[1], a[2], z, z, z, z, z, z], 1)
        return h_x, h, where(abs(h) < 1.0, True, False), cache

    return obs


@pytest.mark.parametrize("research", [False, True], ids=["cached", "research"])
def test_update_iterated_matches_jax(rng, research):
    """The iterated update on the same prior and observations: state within
    1e-4 (m, rad) and P within 1e-5. With research=True the port reads the
    convergence flag back once per iteration after the first."""
    a = _imu_inputs(rng, 20)
    xj, Pj, _ = _j_propagate(*_jax_args(a))
    xt, Pt = convert.nav_state_from_numpy(_np(xj), device="cpu"), torch.from_numpy(np.array(Pj))
    n = 300
    pb = rng.uniform(-8, 8, size=(3, n)).astype(np.float32)
    nrm = rng.normal(size=(3, n))
    nrm = (nrm / np.linalg.norm(nrm, axis=0)).astype(np.float32)
    # planes through the points as seen from a pose 5 cm / 0.01 rad off
    true_pw = np.asarray(jst.boxplus(xj, jnp.asarray(np.r_[0.05, -0.03, 0.02, 0.01, 0, -0.01, np.zeros(17)],
                                                         jnp.float32)).rot) @ pb
    off = (-(nrm * (true_pw + np.asarray(xj.pos)[:, None] + 0.05)).sum(0)).astype(np.float32)
    uj = jeskf.update_iterated(xj, Pj, _plane_obs(jnp, *map(jnp.asarray, (pb, nrm, off))), 0.001, 4, 0.001,
                               research=research)
    ut = teskf.update_iterated(xt, Pt, _plane_obs(torch, *map(torch.from_numpy, (pb, nrm, off))), 0.001, 4, 0.001,
                               research=research)
    dx = tst.boxminus(ut.x, convert.nav_state_from_numpy(_np(uj.x), device="cpu"))
    np.testing.assert_allclose(dx.numpy(), 0.0, atol=1e-4)
    np.testing.assert_allclose(ut.P.numpy(), np.asarray(uj.P), atol=1e-5)
    assert bool(ut.converged) == bool(uj.converged)
    assert int(ut.iterations) == int(uj.iterations)
    assert (ut.host_syncs > 0) == research


def test_map_insert_mask_matches_jax(rng):
    _, tcfg = _cfgs()
    jcfg, _ = _cfgs()
    pw = rng.uniform(-5, 5, size=(3, 400)).astype(np.float32)
    nbrs = (pw[:, None, :] + rng.normal(scale=0.2, size=(3, 5, 400))).astype(np.float32)
    d2 = np.sort(rng.uniform(0, 1, size=(5, 400)), axis=0).astype(np.float32)
    cnt = rng.integers(0, 6, size=400).astype(np.int32)
    mask = rng.uniform(size=400) < 0.9
    mj = jpipe._map_insert_mask(jcfg, *map(jnp.asarray, (pw, mask, nbrs, d2, cnt)))
    mt = tpipe._map_insert_mask(tcfg, *map(torch.from_numpy, (pw, mask, nbrs, d2, cnt)))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


def test_create_state_and_reset_match_jax():
    """A fresh state has the JAX package's leaves, shapes and dtypes."""
    jcfg, tcfg = _cfgs(extrinsic_T=(0.1, -0.2, 0.3))
    sj = _np(jlio.create_state(jcfg))
    st_ = convert.to_numpy(tlio.reset(tcfg, device="cpu"))
    for a, b in zip(jax.tree.leaves(sj), jax.tree.leaves(st_)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
