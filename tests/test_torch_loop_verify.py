"""Parity of SLAM loop verification by point-to-plane ICP (the ScanContext
channel of `pointcloud_slam_tpu_torch.models.liosam.slam._verify_loop`)
with the JAX package: a revisit scan registered against a keyframe's merged
submap, on the same keyframes (JAX's, carried over by `convert`).

JAX runs op by op (`jax.disable_jit()`): compiling its loop ICP costs half
a minute, and JAX's compiled `plane_fit` differs from its own eager ops
(ROADMAP §3): against the compiled ICP the port lands ~6 mm away, against
the eager one ~1e-4 m. The NDT channel is held to JAX's compiled align in
tests/test_torch_slam.py.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pointcloud_slam_tpu import register as jreg
from pointcloud_slam_tpu.geom import se3 as jse3
from pointcloud_slam_tpu.models.liosam import slam as jslam
from pointcloud_slam_tpu_torch import convert, register as treg
from pointcloud_slam_tpu_torch.geom import se3 as tse3
from pointcloud_slam_tpu_torch.io import synthetic as tsyn
from pointcloud_slam_tpu_torch.models.liosam import slam as tslam

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


N_KF = 12
VERIFY_J = jslam.SLAMConfig(n_corner=8, n_surf=512, loop_icp=jreg.ICPConfig(solver=jreg.SolverConfig(max_iterations=6)))
VERIFY_T = tslam.SLAMConfig(n_corner=8, n_surf=512, loop_icp=treg.ICPConfig(solver=treg.SolverConfig(max_iterations=6)))


def _keyframe_scan(world, t, seed):
    s, sm = tsyn.take_scan(world, np.eye(3, dtype=np.float32), t, 512, seed=seed)
    return np.ascontiguousarray(s.T), sm


@pytest.fixture(scope="module")
def keyframes():
    """A JAX SLAMState whose graph and surface store hold 12 keyframes 0.36 m
    apart along a circle in the feature world (all that `_verify_loop`
    reads), the same state in the port, and the surface world."""
    _, surfs_w = tsyn.make_feature_world()
    KF = VERIFY_J.backend.max_keyframes
    poses = np.stack([[6.0 * np.cos(0.06 * i) - 6.0, 6.0 * np.sin(0.06 * i), 1.0] for i in range(N_KF)]).astype(np.float32)
    kf_s = np.zeros((KF, 3, 512), np.float32)
    kf_m = np.zeros((KF, 512), bool)
    for i in range(N_KF):
        kf_s[i], kf_m[i] = _keyframe_scan(surfs_w, poses[i], 6000 + i)
    t_all = np.zeros((KF, 3), np.float32)
    t_all[:N_KF] = poses
    st = jslam.create_state(VERIFY_J)
    st = st._replace(graph=st.graph._replace(t=jnp.asarray(t_all), n=jnp.asarray(N_KF, jnp.int32)),
                     kf_surf=jnp.asarray(kf_s), kf_surf_mask=jnp.asarray(kf_m))
    st = jax.tree.map(np.asarray, st)
    return st, convert.slam_state_from_numpy(st, "cpu"), surfs_w


def _revisit(keyframes, j):
    """A scan 0.22 m from keyframe j and a guess 0.15 m and 2 deg off it."""
    js, ts, surfs_w = keyframes
    true_t = js.graph.t[j] + np.array([0.2, -0.1, 0.0], np.float32)
    s, sm = _keyframe_scan(surfs_w, true_t, 77)
    c, sn = np.float32(np.cos(0.035)), np.float32(np.sin(0.035))
    Rg = np.array([[c, -sn, 0], [sn, c, 0], [0, 0, 1]], np.float32)
    return s, sm, Rg, true_t + np.array([0.1, 0.1, 0.05], np.float32), true_t - js.graph.t[j]


def test_verify_loop_icp_matches_eager_jax(keyframes):
    """ICP verification (the SC channel) of the revisit against keyframe 5's
    merged submap (keyframes 1..9): the relative pose within 5e-4 m / 5e-4
    of eager JAX's, fitness at rtol 1e-4, the same convergence flag and
    verdict; within 5 cm of the truth."""
    js, ts, _ = keyframes
    j = 5
    s, sm, Rg, guess_t, rel_true = _revisit(keyframes, j)
    with jax.disable_jit():
        pj, fit_j, conv_j = jslam._verify_loop(VERIFY_J, jax.tree.map(jnp.asarray, js), jnp.asarray(j),
                                               jse3.Pose(jnp.asarray(Rg), jnp.asarray(guess_t)), jnp.asarray(s),
                                               jnp.asarray(sm), jnp.zeros(()), "icp")
    pt, fit_t, conv_t = tslam._verify_loop(VERIFY_T, ts, j, tse3.Pose(_t(Rg), _t(guess_t)), _t(s), _t(sm),
                                           torch.zeros(()), "icp")
    np.testing.assert_allclose(pt.t.numpy(), np.asarray(pj.t), atol=5e-4)
    np.testing.assert_allclose(pt.R.numpy(), np.asarray(pj.R), atol=5e-4)
    np.testing.assert_allclose(float(fit_t), float(fit_j), rtol=1e-4)
    assert bool(conv_t) == bool(conv_j)
    assert (float(fit_t) < VERIFY_T.loop_fitness_thresh) == (float(fit_j) < VERIFY_J.loop_fitness_thresh)
    assert np.linalg.norm(pt.t.numpy() - rel_true) < 0.05
