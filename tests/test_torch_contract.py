"""Guards of the port's contract: it never imports JAX (nor anything of the
JAX package), its constructors and apps ask for the GPU unless told
otherwise (no silent CPU fallback), the GPU smoke run refuses to run
without a GPU, state carried over from the JAX package round-trips exactly,
and the torch apps run."""

import importlib.util
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
from pointcloud_slam_tpu_torch.models.liosam import backend as tbk, slam as tslam
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
            "import apps.run_slam_offline_torch as slam_app; slam_app.build_config(slam_app.parse_args([]));"
            "import pointcloud_slam_tpu_torch.models.liosam;"
            "import pointcloud_slam_tpu_torch.native, pointcloud_slam_tpu_torch.models.localization;"
            "from pointcloud_slam_tpu_torch.io import converters, lz4, odom_feed, pcd, rosbag;"
            "from pointcloud_slam_tpu_torch.models.lio import preprocess;"
            "import apps.run_localization_torch as loc_app; loc_app.build_config(loc_app.parse_args([]));"
            "sys.path.insert(0, 'tools'); import make_dataset_torch;"
            "import soak_online_torch, soak_localization_torch; soak_online_torch.parse_args([]);"
            "soak_localization_torch.parse_args([]); soak_online_torch.soak_config();"
            "import apps.run_mapping_online_torch as online, apps.run_kitti_torch as kitti;"
            "import apps.mapping_session_torch, apps.visualize_run_torch; online.parse_args([]);"
            "from pointcloud_slam_tpu_torch.ops import phc; from pointcloud_slam_tpu_torch.models.lio import fusion;"
            "from pointcloud_slam_tpu_torch.utils import checkpoint; checkpoint.save_state, checkpoint.load_state;"
            "import pointcloud_slam_tpu_torch.parallel; import dryrun_multichip_torch; dryrun_multichip_torch.parse_args([]);"
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
    "liosam.backend.create": lambda **kw: tbk.create(tbk.BackendConfig(max_keyframes=4, max_loops=2), **kw).R,
    "synthetic.drifting_circle_graph": lambda **kw: synthetic.drifting_circle_graph(
        tbk.BackendConfig(max_keyframes=16, max_loops=2), 1, 3, 8, **kw)[0].t,
    "liosam.slam.create_state": lambda **kw: tslam.create_state(
        tslam.SLAMConfig(backend=tbk.BackendConfig(max_keyframes=4, max_loops=2)), **kw).kf_surf,
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


def _load_entry(rel):
    spec = importlib.util.spec_from_file_location(os.path.basename(rel)[:-3] + "_contract", os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("app", ["run_mapping_offline_torch", "run_slam_offline_torch", "run_localization_torch"])
def test_apps_default_to_the_gpu(app):
    """Each replay app runs on the card unless --device says otherwise, and
    without a GPU it refuses before it reads any input."""
    mod = _load_entry(f"apps/{app}.py")
    assert mod.parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            mod.main(["--synthetic", "1", "--out_dir" if app != "run_mapping_offline_torch" else "--traj_log_file",
                      os.devnull])


# the deployed-mode entry points: (file, arguments of a run that must refuse without a GPU)
DEPLOYED = {
    "apps/run_mapping_online_torch.py": ["--frames", "1"],
    "apps/run_kitti_torch.py": ["no_such_dir"],
    "tools/soak_online_torch.py": ["--seconds", "0.1"],
    "tools/soak_localization_torch.py": ["--seconds", "0.1"],
    "tools/dryrun_multichip_torch.py": [],
}


@pytest.mark.parametrize("rel", sorted(DEPLOYED))
def test_deployed_entry_points_default_to_the_gpu(rel):
    """The online mapper, the KITTI app and both soaks run on the card unless
    --device says otherwise; without a GPU they refuse before any work. The
    session CLI passes --device to the apps it launches and refuses to launch
    them on a machine without a GPU."""
    mod = _load_entry(rel)
    args = DEPLOYED[rel]
    assert mod.parse_args(args).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            mod.main(args)


def test_session_defaults_to_the_gpu(tmp_path, capsys):
    ms = _load_entry("apps/mapping_session_torch.py")
    ms.main(["--root", str(tmp_path), "start", "--synthetic", "2"])
    assert "run_mapping_offline_torch.py --synthetic 2 --device cuda" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            ms.main(["--root", str(tmp_path), "start", "--synthetic", "2", "--run"])


@pytest.mark.parametrize("rel", ["apps/run_mapping_online_torch.py", "apps/run_kitti_torch.py",
                                 "apps/mapping_session_torch.py", "apps/visualize_run_torch.py",
                                 "tools/soak_online_torch.py", "tools/soak_localization_torch.py",
                                 "tools/make_dataset_torch.py", "tools/dryrun_multichip_torch.py"])
def test_entry_point_help(rel, capsys):
    mod = _load_entry(rel)
    with pytest.raises(SystemExit) as e:
        (mod.parse_args if hasattr(mod, "parse_args") else mod.main)(["--help"])
    assert e.value.code == 0 and "usage:" in capsys.readouterr().out


def test_align_bench_app_runs_on_cpu():
    """apps/align_bench_torch.py at a small size on the CPU: every ported
    row runs and reports a finite fitness; the registrations land within
    0.1 m of the known offset, the NDT rows within 0.15 m (the JAX
    package's D2D gate; on these 3,000-point clouds JAX's own P2D lands
    0.1436 m off, and the port's within 1e-6 m of it)."""
    r = _run(["apps/align_bench_torch.py", "--device", "cpu", "--n_points", "3000", "--reps", "1"], timeout=300)
    assert r.returncode == 0, r.stderr
    table = r.stdout.split("\n\n")[-1].strip().splitlines()[1:]
    names = [ln[:26].strip() for ln in table]
    assert names == ["point_to_plane_icp", "ndt_p2d", "ndt_d2d", "vgicp (knn cov)", "vgicp (rbf cov)",
                     "vgicp (exact/pallas cov)", "gicp"], names
    for name, ln in zip(names, table):
        assert float(ln.split("terr=")[1]) < (0.15 if name.startswith("ndt") else 0.1), ln
    assert "cov: exact knn" in r.stdout and "cov: voxel knn" in r.stdout and "cov: rbf" in r.stdout


def test_multichip_dry_run_on_cpu():
    """tools/dryrun_multichip_torch.py --device cpu: 4 ranks on a gloo group
    (mesh (2, 2)) run the four sharded calls, every rank's outputs are
    equal, and the backend's error falls."""
    r = _run(["tools/dryrun_multichip_torch.py", "--device", "cpu"], timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    line = r.stdout.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip ok: mesh={'dp': 2, 'sp': 2}") and "backend=gloo" in line, line
