"""The port's last app and config functions against the JAX package:
`utils/config.py`'s overlay and writer (tests/test_utils.py's cases, and
files the port writes read back by the JAX loader),
`apps/align_bench_torch.py --target/--source/--leaf` on a PCD pair with a
known offset (the same subsample as `apps/align_bench.py`), and
`apps/run_slam_offline_torch.py --debug` (the JAX app's channel and array
names)."""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from pointcloud_slam_tpu.io import pcd as jpcd
from pointcloud_slam_tpu.utils import config as jconfig
from pointcloud_slam_tpu_torch.io import pcd as tpcd, synthetic as tsyn
from pointcloud_slam_tpu_torch.utils import config as tconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import apps.align_bench_torch as bench  # noqa: E402
import apps.run_slam_offline_torch as slam_app  # noqa: E402

torch.set_num_threads(2)


def test_yaml_roundtrip(tmp_path):
    """tests/test_utils.py::TestConfig::test_yaml_roundtrip on the port."""
    cfg = {
        "mapping": {"filter_size_surf": 0.5, "max_iteration": 4, "extrinsic_est_en": True},
        "lidar_type": 1,
        "extrinsic_T": [0.04165, 0.02326, -0.0284],
        "name": "livox",
    }
    path = str(tmp_path / "cfg.yaml")
    tconfig.save_yaml(path, cfg)
    back = tconfig.load_yaml(path)
    assert back["mapping"]["filter_size_surf"] == 0.5
    assert back["mapping"]["max_iteration"] == 4
    assert back["mapping"]["extrinsic_est_en"] is True
    assert back["extrinsic_T"] == [0.04165, 0.02326, -0.0284]
    assert back["name"] == "livox"


def test_overlay(tmp_path):
    """tests/test_utils.py::TestConfig::test_overlay on the port, and a
    missing local file or system copy."""
    local = str(tmp_path / "local.yaml")
    system = str(tmp_path / "system.yaml")
    tconfig.save_yaml(local, {"a": 1, "nest": {"x": 1, "y": 2}})
    tconfig.save_yaml(system, {"nest": {"y": 9}})
    merged = tconfig.load_with_overlay(local, system)
    assert merged["a"] == 1 and merged["nest"]["x"] == 1 and merged["nest"]["y"] == 9
    assert merged == jconfig.load_with_overlay(local, system)
    assert tconfig.load_with_overlay(local, str(tmp_path / "absent.yaml")) == {"a": 1, "nest": {"x": 1, "y": 2}}
    assert tconfig.load_with_overlay(str(tmp_path / "absent.yaml"), system) == {"nest": {"y": 9}}


def test_port_writes_what_the_jax_loader_reads(tmp_path):
    """A file the port's save_yaml writes loads equal through the JAX loader,
    byte for byte the file the JAX writer makes, on a per-lidar config of
    the repo (configs/lio/velodyne.yaml) and nested lists, flags, strings."""
    cfgs = [tconfig.load_yaml(os.path.join(ROOT, "configs", "lio", "velodyne.yaml")),
            {"common": {"lid_topic": "/points_raw", "time_sync_en": False},
             "preprocess": {"lidar_type": 2, "scan_line": 16, "blind": 4.0},
             "mapping": {"extrinsic_R": [1, 0, 0, 0, 1, 0, 0, 0, 1], "fov_degree": 180.0, "empty": []}}]
    for i, cfg in enumerate(cfgs):
        tp, jp = str(tmp_path / f"port{i}.yaml"), str(tmp_path / f"jax{i}.yaml")
        tconfig.save_yaml(tp, cfg)
        jconfig.save_yaml(jp, cfg)
        assert jconfig.load_yaml(tp) == cfg == tconfig.load_yaml(tp)
        with open(tp, "rb") as a, open(jp, "rb") as b:
            assert a.read() == b.read()


@pytest.fixture(scope="module")
def pcd_pair(tmp_path_factory):
    """The synthetic room's pair written as PCDs: 5,000 target points and
    4,000 source points seen from random_pose(seed=1, 0.05, 0.3)."""
    d = tmp_path_factory.mktemp("align_pair")
    world = tsyn.make_room_cloud(40_000, seed=0)
    R, t = tsyn.random_pose(seed=1, rot_scale=0.05, trans_scale=0.3)
    g = np.random.default_rng(5)
    tgt = world[g.choice(len(world), 5000, replace=False)]
    src = (world[g.choice(len(world), 4000, replace=False)] - t) @ R
    paths = str(d / "target.pcd"), str(d / "source.pcd")
    tpcd.write_pcd(paths[0], tgt.astype(np.float32))
    tpcd.write_pcd(paths[1], src.astype(np.float32))
    return paths, t


def test_align_bench_subsamples_as_the_jax_app(pcd_pair):
    """`load_pair` picks the points apps/align_bench.py picks: min(len(tgt),
    len(src), n_points) of each by one default_rng(0), the target first."""
    (target, source), _ = pcd_pair
    for n_points in (3000, 4000, 17_000):
        tgt, src = bench.load_pair(target, source, n_points)
        jt, js = jpcd.read_pcd_xyz(target), jpcd.read_pcd_xyz(source)   # apps/align_bench.py:45-51
        n = min(len(jt), len(js), n_points)
        rngl = np.random.default_rng(0)
        jt = jt[rngl.choice(len(jt), n, replace=False)]
        js = js[rngl.choice(len(js), n, replace=False)]
        assert tgt.shape == (n, 3) and np.array_equal(tgt, jt) and np.array_equal(src, js)


def test_align_bench_on_a_pcd_pair(pcd_pair, capsys):
    """apps/align_bench_torch.py --target --source --leaf --device cpu
    --reps 1: every row runs on the PCD pair, no row prints a terr (there is
    no ground truth), and GICP lands within 0.1 m of the offset the pair was
    written with; a lone --target is refused."""
    (target, source), t = pcd_pair
    rows = bench.main(["--target", target, "--source", source, "--leaf", "0.2", "--device", "cpu",
                       "--n_points", "3000", "--reps", "1"])
    out = capsys.readouterr().out
    assert [r[0] for r in rows] == ["point_to_plane_icp", "ndt_p2d", "ndt_d2d", "vgicp (knn cov)",
                                    "vgicp (rbf cov)", "vgicp (exact/pallas cov)", "gicp"]
    assert "terr" not in out and all(r[4] is None for r in rows)
    assert all(np.isfinite(r[3]) and np.isfinite(r[5]).all() for r in rows)
    gicp = dict((r[0], r[5]) for r in rows)["gicp"]
    assert np.linalg.norm(gicp - t) < 0.1, (gicp, t)
    with pytest.raises(SystemExit):
        bench.main(["--target", target, "--device", "cpu"])


def test_slam_app_debug_channels_on_cpu(tmp_path):
    """run_slam_offline_torch.py --synthetic 12 --debug effect_points,
    loop_constraints --device cpu: one effect_points file a keyframe, each
    with `pts` (3, n) the keyframe's masked surface points (the JAX app's
    name); no loop_constraints file unless a loop closed, and then the JAX
    app's names. Without --debug no debug directory."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    out_dir = tmp_path / "slam"
    r = subprocess.run([sys.executable, "apps/run_slam_offline_torch.py", "--synthetic", "12", "--device", "cpu",
                        "--debug", "effect_points,loop_constraints", "--save_artifacts", "--out_dir", str(out_dir)],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    keyframes = int(r.stdout.split("keyframes: ")[1].split()[0])
    loops = int(r.stdout.split("loops: ")[1].split()[0])
    files = sorted(os.listdir(out_dir / "debug"))
    effect = [f for f in files if f.startswith("effect_points_")]
    assert keyframes > 1 and len(effect) == keyframes, (files, keyframes)
    for k, f in enumerate(effect):
        d = np.load(out_dir / "debug" / f)
        assert set(d.files) == {"pts", "_frame", "_stamp"}
        pts = d["pts"]
        assert pts.dtype == np.float32 and pts.shape[0] == 3 and pts.shape[1] > 0 and np.isfinite(pts).all()
        saved = tpcd.read_pcd_xyz(str(out_dir / "Scans" / f"{k:06d}.pcd"))   # the same keyframe's artifact
        np.testing.assert_array_equal(np.sort(saved, axis=0), np.sort(pts.T, axis=0))
    loop_files = [f for f in files if f.startswith("loop_constraints_")]
    assert len(loop_files) == loops
    for f in loop_files:
        assert set(np.load(out_dir / "debug" / f).files) == {"pairs", "endpoints_i", "endpoints_j", "_frame", "_stamp"}
    plain = tmp_path / "plain"
    r = subprocess.run([sys.executable, "apps/run_slam_offline_torch.py", "--synthetic", "3", "--device", "cpu",
                        "--out_dir", str(plain)], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert not (plain / "debug").exists()


def test_slam_app_loop_constraints_record(tmp_path):
    """`record_debug` on a state holding two loop factors, as the JAX app
    publishes them (apps/run_slam_offline.py:172-188): `pairs` (n_loops, 2)
    int32 of (loop_i, loop_j), `endpoints_i` / `endpoints_j` the keyframe
    positions; with the channels disabled it never reads `out`."""
    from pointcloud_slam_tpu_torch.models.liosam import slam
    from pointcloud_slam_tpu_torch.utils import log as plog

    cfg = slam_app.build_config(slam_app.parse_args(["--max_keyframes", "16", "--n_corner", "8", "--n_surf", "16"]))
    state = slam.create_state(cfg, device="cpu")
    t = torch.arange(48, dtype=torch.float32).reshape(16, 3)
    li = torch.zeros_like(state.graph.loop_i)
    lj = torch.zeros_like(state.graph.loop_j)
    li[:2], lj[:2] = torch.tensor([9, 12]), torch.tensor([1, 3])
    graph = state.graph._replace(t=t, loop_i=li, loop_j=lj, n_loops=torch.tensor(2, dtype=torch.int32))
    state = state._replace(graph=graph)
    dbg = plog.DebugChannels(str(tmp_path / "debug"), enabled=["loop_constraints"])
    slam_app.record_debug(dbg, 7, state, types.SimpleNamespace(loop_detected=torch.tensor(True),
                                                               is_keyframe=torch.tensor(False)))
    dbg.close()
    d = np.load(tmp_path / "debug" / "loop_constraints_000000.npz")
    assert d["pairs"].dtype == np.int32 and d["pairs"].tolist() == [[9, 1], [12, 3]]
    np.testing.assert_array_equal(d["endpoints_i"], t.numpy()[[9, 12]])
    np.testing.assert_array_equal(d["endpoints_j"], t.numpy()[[1, 3]])
    assert int(d["_frame"]) == 7

    class Unread:
        def __getattr__(self, name):
            raise AssertionError(f"read {name} with every channel disabled")

    slam_app.record_debug(plog.DebugChannels(str(tmp_path / "off")), 0, state, Unread())
    assert not (tmp_path / "off").exists()
