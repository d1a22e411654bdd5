"""The port's KITTI and session product paths on the CPU:
`tools/make_dataset_torch.py kitti` byte for byte against `tools/make_dataset.py
kitti`; `apps/run_kitti_torch.py` for each `--algo` on that sequence against
its `poses.txt`, within the bound stated below; and the cases of
tests/test_mapping_session.py and tests/test_visualize.py on
`apps/mapping_session_torch.py` and `apps/visualize_run_torch.py`.
"""

import argparse
import filecmp
import importlib.util
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = REPO
_spec = importlib.util.spec_from_file_location("mapping_session_torch", os.path.join(REPO, "apps", "mapping_session_torch.py"))
ms = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ms)

KITTI_FRAMES, KITTI_POINTS = 5, 5000
# the largest position error against poses.txt over the 5 frames (3.2 m of
# travel), per algorithm: 1.5 x what the port measured on the CPU (ICP
# 0.0629 m, NDT 0.0168, VGICP 0.1669), where apps/run_kitti.py lands
# 0.0624 / 0.0168 / 0.167 m on the same files (frame-to-frame drift of the
# workload at 5,000 points, not of the port)
KITTI_MAX_ERR_M = {"icp": 0.095, "ndt": 0.025, "vgicp": 0.25}


def _run(args, timeout=240, cwd=REPO):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


@pytest.fixture(scope="module")
def kitti_seq(tmp_path_factory):
    """The synthetic street sequence written by both tools: identical files."""
    root = tmp_path_factory.mktemp("kitti")
    args = ["kitti", "--frames", str(KITTI_FRAMES), "--points", str(KITTI_POINTS), "--seed", "2"]
    _run(["tools/make_dataset.py", *args, "--out", str(root / "jax")])
    _run(["tools/make_dataset_torch.py", *args, "--out", str(root / "port")])
    return root


def test_kitti_dataset_byte_identical_to_jax_tool(kitti_seq):
    cmp = filecmp.dircmp(kitti_seq / "jax", kitti_seq / "port")
    names = ["poses.txt", "calib.txt"] + [f"velodyne/{f:06d}.bin" for f in range(KITTI_FRAMES)]
    match, mismatch, errors = filecmp.cmpfiles(kitti_seq / "jax", kitti_seq / "port", names, shallow=False)
    assert match == names and not mismatch and not errors and not cmp.left_only and not cmp.right_only


def kitti_errors(poses_file, est_file):
    """(final, max) position error of a KITTI pose file against the sequence's
    ground truth, expressed in its first frame."""
    gt = np.loadtxt(poses_file).reshape(-1, 3, 4)
    est = np.loadtxt(est_file).reshape(-1, 3, 4)
    rel = np.einsum("ji,nj->ni", gt[0, :, :3], gt[:, :, 3] - gt[0, :, 3])
    e = np.linalg.norm(est[:, :, 3] - rel, axis=1)
    return float(e[-1]), float(e.max())


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("algo", ["icp", "ndt", "vgicp"])
def test_run_kitti_tracks_the_street(kitti_seq, algo, tmp_path, capsys):
    out = tmp_path / "poses.txt"
    _load("apps/run_kitti_torch.py", "run_kitti_torch").main(
        [str(kitti_seq / "port"), "--algo", algo, "--n_points", str(KITTI_POINTS), "--device", "cpu", "--out", str(out)])
    assert f"done: {KITTI_FRAMES} frames" in capsys.readouterr().out
    assert np.loadtxt(out).shape == (KITTI_FRAMES, 12)
    final, worst = kitti_errors(kitti_seq / "port" / "poses.txt", out)
    assert worst < KITTI_MAX_ERR_M[algo], (algo, final, worst)


def _start_args(root, **kw):
    return argparse.Namespace(
        root=str(root), map_name=kw.get("map_name", "Proj-Loc"),
        activate=kw.get("activate", "y"), mode=kw.get("mode", "fast"),
        data_dir="", synthetic=4, run=kw.get("run", False), device="cpu", session="")


class TestStart:
    def test_creates_session_and_symlinks(self, tmp_path, capsys):
        session = ms.cmd_start(_start_args(tmp_path))
        assert os.path.isdir(os.path.join(session, "details", "frames"))
        assert os.path.basename(session).startswith("Proj-Loc-")
        default = tmp_path / "system" / "maps" / "default"
        assert os.path.islink(default) and os.path.realpath(default) == os.path.realpath(session)
        # activate=y also points the system map at the session (mapping.sh:47-52)
        active = tmp_path / "system" / "map"
        assert os.path.islink(active) and os.path.realpath(active) == os.path.realpath(session)
        # dry run prints the pipeline it would launch (fast -> LIO pipeline)
        out = capsys.readouterr().out
        assert "run_mapping_offline_torch.py" in out and "--device cpu" in out

    def test_non_symlink_default_is_backed_up(self, tmp_path):
        maps = tmp_path / "system" / "maps"
        os.makedirs(maps / "default")
        (maps / "default" / "keep.txt").write_text("x")
        ms.cmd_start(_start_args(tmp_path, activate="n"))
        backups = [d for d in os.listdir(maps) if d.startswith("default-")]
        assert len(backups) == 1, "real default dir must be backed up, not deleted"
        assert (maps / backups[0] / "keep.txt").exists()
        assert os.path.islink(maps / "default")

    def test_indoor_mode_composes_slam_pipeline(self, tmp_path, capsys):
        ms.cmd_start(_start_args(tmp_path, mode="indoor", activate="n"))
        out = capsys.readouterr().out
        assert "run_slam_offline_torch.py" in out and "--save_artifacts" in out


class TestRegisterConf:
    def test_registers_by_lidar_type_and_is_idempotent(self, tmp_path):
        conf = tmp_path / "system" / "conf"
        os.makedirs(conf)
        (conf / "lidar_type").write_text("velodyne\n")
        args = argparse.Namespace(root=str(tmp_path), lidar_type="")
        ms.cmd_register_conf(args)
        lio_params = conf / "slam" / "jueying_lio" / "params.yaml"
        assert lio_params.exists()
        ref = open(os.path.join(REPO, "configs", "lio", "velodyne.yaml")).read()
        assert lio_params.read_text() == ref
        # jueying_slam has no velodyne.yaml -> falls back to a shipped config
        assert (conf / "slam" / "jueying_slam" / "params.yaml").exists()
        # idempotent: user-edited params survive re-registration
        lio_params.write_text("edited: true\n")
        ms.cmd_register_conf(args)
        assert lio_params.read_text() == "edited: true\n"


class TestSessionCommands:
    def test_floor_label_and_save_map(self, tmp_path, capsys):
        session = ms.cmd_start(_start_args(tmp_path))
        ns = argparse.Namespace(root=str(tmp_path), session="", label=2)
        ms.cmd_set_floor_label(ns)
        assert (open(os.path.join(session, "details", "floor_label")).read().strip() == "2")
        hist = open(os.path.join(session, "details", "floor_label_history.csv")).read()
        assert hist.strip().endswith(",2")

        # fake occupancy product inside the session -> save-map publishes it
        with open(os.path.join(session, "details", "occ.pgm"), "wb") as f:
            f.write(b"P5\n2 2\n255\n\x00\x00\x00\x00")
        with open(os.path.join(session, "details", "occ.yaml"), "w") as f:
            f.write("resolution: 0.1\n")
        ms.cmd_save_map(argparse.Namespace(root=str(tmp_path), session="", name="jueying"))
        assert (tmp_path / "system" / "map" / "jueying.pgm").exists()
        assert (tmp_path / "system" / "map" / "jueying.yaml").exists()

    def test_stop_kills_only_recorded_pids(self, tmp_path):
        session = ms.cmd_start(_start_args(tmp_path, activate="n"))
        p = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
        with open(os.path.join(session, "details", "pids"), "w") as f:
            f.write(f"{p.pid}\n")
        ms.cmd_stop(argparse.Namespace(root=str(tmp_path), session=""))
        t0 = time.time()
        while p.poll() is None and time.time() - t0 < 5:
            time.sleep(0.05)
        assert p.poll() is not None, "recorded pid must be terminated"
        assert p.returncode == -signal.SIGTERM
        assert not os.path.exists(os.path.join(session, "details", "pids"))

    def test_save_map_without_product_errors(self, tmp_path):
        ms.cmd_start(_start_args(tmp_path, activate="n"))
        with pytest.raises(SystemExit):
            ms.cmd_save_map(argparse.Namespace(root=str(tmp_path), session="", name="jueying"))


class TestReviewRegressions:
    """Fixes from the round-3 session-4 code review."""

    def test_save_map_rewrites_yaml_image_field(self, tmp_path):
        session = ms.cmd_start(_start_args(tmp_path, activate="n"))
        with open(os.path.join(session, "details", "occ.pgm"), "wb") as f:
            f.write(b"P5\n2 2\n255\n\x00\x00\x00\x00")
        with open(os.path.join(session, "details", "occ.yaml"), "w") as f:
            f.write(f"image: {session}/details/occ.pgm\nresolution: 0.1\n")
        ms.cmd_save_map(argparse.Namespace(root=str(tmp_path), session="", name="pub"))
        y = (tmp_path / "system" / "map" / "pub.yaml").read_text()
        assert "image: pub.pgm" in y, y          # not the stale session path
        assert str(session) not in y

    def test_start_backs_up_published_map_dir(self, tmp_path):
        # save-map makes <root>/system/map a REAL directory; a later
        # `start --activate y` must back it up, never rmtree it
        session = ms.cmd_start(_start_args(tmp_path, activate="n"))
        with open(os.path.join(session, "details", "occ.pgm"), "wb") as f:
            f.write(b"P5\n2 2\n255\n\x00\x00\x00\x00")
        with open(os.path.join(session, "details", "occ.yaml"), "w") as f:
            f.write("resolution: 0.1\n")
        ms.cmd_save_map(argparse.Namespace(root=str(tmp_path), session="", name="keepme"))
        assert (tmp_path / "system" / "map" / "keepme.pgm").exists()
        ms.cmd_start(_start_args(tmp_path, map_name="Second"))
        # the published pair survives in a backup directory
        backups = [d for d in (tmp_path / "system").iterdir() if d.name.startswith("map-")]
        assert backups, "published map dir was destroyed instead of backed up"
        assert any((b / "keepme.pgm").exists() for b in backups)

    def test_interactive_menu_dispatches(self, tmp_path, monkeypatch, capsys):
        # option 1 (start) + option 3 (floor label) + q — the interactive
        # namespace must carry every attribute the handlers read
        answers = iter(["1", "IMap", "n", "fast", "3", "7", "q"])
        monkeypatch.setattr("builtins.input", lambda *a: next(answers))
        ms.cmd_interactive(argparse.Namespace(root=str(tmp_path), session=""))
        out = capsys.readouterr().out
        assert "session:" in out
        maps = list((tmp_path / "system" / "maps").iterdir())
        assert any(d.name.startswith("IMap-") for d in maps)


def test_pub_occ_map_validates_and_publishes(tmp_path, capsys):
    from pointcloud_slam_tpu_torch.maps import occupancy as occ

    session = ms.cmd_start(_start_args(tmp_path, activate="n"))
    cfg = occ.OccupancyConfig(size=32, resolution=0.25, max_range=5.0)
    occ.save_pgm(cfg, occ.create(cfg, device="cpu"), os.path.join(session, "details", "occ"))
    ms.cmd_pub_occ_map(argparse.Namespace(root=str(tmp_path), session="", name="pub"))
    out = capsys.readouterr().out
    assert "publishing" in out and "32x32" in out
    assert (tmp_path / "system" / "map" / "pub.pgm").exists()


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A miniature run_slam_offline_torch-shaped output dir: graph.g2o + Scans/."""
    from pointcloud_slam_tpu_torch.io import pcd as pcdio
    from pointcloud_slam_tpu_torch.models.liosam import backend as bk
    from pointcloud_slam_tpu_torch.utils import checkpoint as ck

    out = tmp_path_factory.mktemp("run")
    KF = 12
    cfg = bk.BackendConfig(max_keyframes=16, max_loops=4)
    g = bk.create(cfg, device="cpu")
    ang = np.linspace(0, 2 * np.pi, KF).astype(np.float32)
    t = np.stack([5 * np.cos(ang), 5 * np.sin(ang), 0 * ang], 1)
    eye = torch.eye(3).expand(16, 3, 3).clone()
    tt = np.zeros((16, 3), np.float32)
    tt[:KF] = t
    odom_t = np.zeros((16, 3), np.float32)
    odom_t[1:KF] = np.diff(t, axis=0)
    g = g._replace(
        R=eye, t=torch.from_numpy(tt), n=torch.tensor(KF, dtype=torch.int32),
        odom_R=eye.clone(), odom_t=torch.from_numpy(odom_t), odom_info=torch.full((16, 6), 1e2),
        loop_i=torch.zeros(4, dtype=torch.int32), loop_j=torch.tensor([KF - 1, 0, 0, 0], dtype=torch.int32),
        loop_R=torch.eye(3).expand(4, 3, 3).clone(), loop_t=torch.zeros(4, 3), loop_info=torch.full((4, 6), 1e3),
        n_loops=torch.tensor(1, dtype=torch.int32),
    )
    ck.save_pose_graph_g2o(str(out / "graph.g2o"), g)
    scans = out / "Scans"
    scans.mkdir()
    rng = np.random.default_rng(0)
    for k in range(0, KF, 3):
        pts = rng.normal(0, 1.0, (200, 3)).astype(np.float32)
        pcdio.write_pcd(str(scans / f"{k:06d}.pcd"), pts)
        # real --save_artifacts dirs also hold feature-channel files the
        # renderer must skip
        pcdio.write_pcd(str(scans / f"{k:06d}_corner.pcd"), pts[:20])
    return str(out)


def test_visualize_from_run_dir(run_dir, tmp_path, capsys):
    out_png = str(tmp_path / "viz.png")
    viz = _load("apps/visualize_run_torch.py", "visualize_run_torch")
    viz.render(viz.parse_args(["--run_dir", run_dir, "--side", "--out", out_png]))
    assert os.path.exists(out_png) and os.path.getsize(out_png) > 10_000
    assert "1 loops" in capsys.readouterr().out


def test_visualize_with_occupancy(run_dir, tmp_path):
    from pointcloud_slam_tpu_torch.maps import occupancy as occ

    cfg = occ.OccupancyConfig(size=64, resolution=0.25, max_range=10.0)
    grid = occ.create(cfg, device="cpu")
    base = str(tmp_path / "map")
    occ.save_pgm(cfg, grid, base)
    out_png = str(tmp_path / "viz2.png")
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "apps", "visualize_run_torch.py"),
         "--run_dir", run_dir, "--map_yaml", base + ".yaml", "--out", out_png],
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(out_png)


def test_publish_twice_into_an_activated_session(tmp_path, capsys):
    """An activating start makes <root>/system/map the session itself: a
    second publication finds the published PGM as the newest product and
    leaves it in place (the JAX app copies it onto itself and raises)."""
    from pointcloud_slam_tpu_torch.maps import occupancy as occ

    session = ms.cmd_start(_start_args(tmp_path, activate="y"))
    cfg = occ.OccupancyConfig(size=32, resolution=0.25, max_range=5.0)
    occ.save_pgm(cfg, occ.create(cfg, device="cpu"), os.path.join(session, "details", "occ"))
    ns = argparse.Namespace(root=str(tmp_path), session="", name="jueying")
    ms.cmd_save_map(ns)
    ms.cmd_pub_occ_map(ns)
    assert "publishing" in capsys.readouterr().out
    y = (tmp_path / "system" / "map" / "jueying.yaml").read_text()
    assert "image: jueying.pgm" in y and (tmp_path / "system" / "map" / "jueying.pgm").exists()
