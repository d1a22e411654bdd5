"""Guards of the port's contract: it never imports JAX, its constructors
ask for the GPU unless told otherwise (no silent CPU fallback), the GPU
smoke run refuses to run without a GPU, state carried over from the JAX
package round-trips exactly, and the torch apps run."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pointcloud_slam_tpu import ops as jops
from pointcloud_slam_tpu.models import lio as jlio
from pointcloud_slam_tpu.models.lio import state as jst
from pointcloud_slam_tpu_torch import convert, ops as tops
from pointcloud_slam_tpu_torch.io import feed, synthetic
from pointcloud_slam_tpu_torch.models import lio as tlio
from pointcloud_slam_tpu_torch.ops import gaussian_grid as tgg

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=ROOT, timeout=120):
    # two intra-op threads: under parallel test workers a subprocess that
    # spins up one thread per core slows down by an order of magnitude
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_port_and_app_never_import_jax():
    code = ("import sys; sys.path.insert(0, '.'); import pointcloud_slam_tpu_torch, chip_smoke;"
            "from pointcloud_slam_tpu_torch import convert; import apps.run_mapping_offline_torch as app;"
            "import pointcloud_slam_tpu_torch.register, pointcloud_slam_tpu_torch.ops.gaussian_grid;"
            "import apps.align_bench_torch as bench; bench.parse_args([]);"
            "app.build_config(app.parse_args(['--config_file', 'configs/lio/velodyne.yaml']));"
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m);"
            "assert not any(m.startswith('pointcloud_slam_tpu.') or m == 'pointcloud_slam_tpu' for m in sys.modules);"
            "print('clean')")
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
    b = convert.to_numpy(convert.lio_state_from_numpy(a, device="cpu"))
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


def _frame_args():
    pts = np.zeros((10, 3), np.float32)
    return (pts, np.zeros(10, np.float32), np.zeros((2, 3), np.float32), np.zeros((2, 3), np.float32),
            np.array([0.005, 0.01], np.float32))


CONSTRUCTORS = {
    "create_state": lambda **kw: tlio.create_state(tlio.LIOConfig(grid=tops.GridConfig(capacity=1 << 8)), **kw).P,
    "reset": lambda **kw: tlio.reset(tlio.LIOConfig(grid=tops.GridConfig(capacity=1 << 8)), **kw).P,
    "voxel_grid.create": lambda **kw: tops.create(tops.GridConfig(capacity=1 << 8), **kw).pts,
    "gaussian_grid.create": lambda **kw: tgg.create(tops.GridConfig(capacity=1 << 8), **kw).sum,
    "feed.make_frame": lambda **kw: feed.make_frame(*_frame_args(), n_points=16, n_imu=4, **kw).pts,
    "synthetic.simulate_lio_sequence": lambda **kw: synthetic.simulate_lio_sequence(
        n_frames=1, n_pts=100, **kw)[2][0][0].pts,
    "convert.nav_state_from_numpy": lambda **kw: convert.nav_state_from_numpy(
        jax.tree.map(np.asarray, jst.identity()), **kw).pos,
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructors_default_to_the_gpu(name):
    """Without a device the port's constructors ask for CUDA: on a machine
    without a GPU they raise instead of quietly returning CPU tensors; with
    device="cpu" they build on the CPU."""
    make = CONSTRUCTORS[name]
    assert make(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            make()


def test_align_bench_app_runs_on_cpu():
    """apps/align_bench_torch.py at a small size on the CPU: every ported
    row runs and reports a finite fitness; the registrations land within
    0.1 m of the known offset."""
    r = _run(["apps/align_bench_torch.py", "--device", "cpu", "--n_points", "3000", "--reps", "1"], timeout=300)
    assert r.returncode == 0, r.stderr
    table = r.stdout.split("\n\n")[-1].strip().splitlines()[1:]
    names = [ln[:26].strip() for ln in table]
    assert names == ["point_to_plane_icp", "vgicp (knn cov)", "vgicp (exact/pallas cov)", "gicp"], names
    for ln in table:
        assert float(ln.split("terr=")[1]) < 0.1, ln
    assert "cov: exact knn" in r.stdout and "cov: voxel knn" in r.stdout
