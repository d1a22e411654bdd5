"""Guards of the port's contract: it never imports JAX, the GPU smoke run
refuses to run without a GPU (no silent CPU fallback), state carried over
from the JAX package round-trips exactly, and the torch app runs."""

import os
import shutil
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import torch

from pointcloud_slam_tpu import ops as jops
from pointcloud_slam_tpu.models import lio as jlio
from pointcloud_slam_tpu.models.lio import state as jst
from pointcloud_slam_tpu_torch import convert

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=ROOT, timeout=120):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_port_and_app_never_import_jax():
    code = ("import sys; sys.path.insert(0, '.'); import pointcloud_slam_tpu_torch, chip_smoke;"
            "from pointcloud_slam_tpu_torch import convert; import apps.run_mapping_offline_torch as app;"
            "app.build_config(app.parse_args(['--config_file', 'configs/lio/velodyne.yaml']));"
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m); print('clean')")
    r = _run(["-c", code])
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """No CUDA device: non-zero exit and no result line — in the repo, and as
    a lone copy of the script outside it."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    for args, cwd in ((["chip_smoke.py"], ROOT), ([str(alone)], str(tmp_path))):
        r = _run(args, cwd=cwd)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout


def test_convert_round_trips_jax_state_exactly(rng):
    """JAX LIOState -> numpy -> port -> numpy: every leaf equal, same dtype."""
    cfg = jlio.LIOConfig(grid=jops.GridConfig(capacity=1 << 10, pts_per_voxel=4, resolution=0.5, nearby=7))
    s = jlio.create_state(cfg)
    pts = jnp.asarray(rng.uniform(-3, 3, size=(3, 300)).astype(np.float32))
    s = s._replace(
        x=jst.boxplus(s.x, jnp.asarray(rng.normal(size=23).astype(np.float32) * 0.1)),
        grid=jops.insert(cfg.grid, s.grid, pts, jnp.ones(300, bool)),
        initialized=jnp.asarray(True), init_count=jnp.asarray(23, jnp.int32),
        acc_sum=jnp.asarray([1.0, 2.0, 3.0], jnp.float32),
    )
    a = jax.tree.map(np.asarray, s)
    b = convert.to_numpy(convert.lio_state_from_numpy(a))
    leaves_a, leaves_b = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(leaves_a) == len(leaves_b)
    assert np.asarray(a.grid.fp).max() > 2 ** 31  # fingerprints use the full uint32 range
    for x, y in zip(leaves_a, leaves_b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_torch_app_runs_on_cpu(tmp_path):
    traj = tmp_path / "traj.txt"
    r = _run(["apps/run_mapping_offline_torch.py", "--synthetic", "8", "--n_points", "1500",
              "--device", "cpu", "--traj_log_file", str(traj)])
    assert r.returncode == 0, r.stderr
    rows = np.loadtxt(traj)
    assert rows.shape == (8, 8) and np.isfinite(rows).all()
    # the TUM quaternions are unit
    np.testing.assert_allclose(np.linalg.norm(rows[:, 4:], axis=1), 1.0, atol=1e-5)
