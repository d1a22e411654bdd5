"""The port's host modules of the mapping app on the CPU: grid auto-tuning
(`ops/tuning.py`, tests/test_tuning.py mirrored, `suggest_grid` equal to
JAX's on the same scans), the Timer registry and the glog-style logger
(tests/test_utils.py's TestTimer / TestLogging mirrored), and the mapping
app with `--auto_grid --time_log_file` on a synthetic replay, its CSV read
by `apps/plot_timings.read_timer_csv`."""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from pointcloud_slam_tpu.ops import tuning as tuning_j
from pointcloud_slam_tpu_torch import ops
from pointcloud_slam_tpu_torch.io import synthetic
from pointcloud_slam_tpu_torch.ops import tuning
from pointcloud_slam_tpu_torch.utils import log
from pointcloud_slam_tpu_torch.utils.timer import Timer

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _scan(n, seed=0):
    world = synthetic.make_room_cloud(40_000, seed=seed)
    rng = np.random.default_rng(seed)
    return world[rng.choice(len(world), size=n, replace=False)].astype(np.float32)


def test_spacing_estimate_grid():
    g = np.mgrid[0:20, 0:20, 0:3].reshape(3, -1).T.astype(np.float64) * 0.25
    assert abs(tuning.estimate_spacing(g) - 0.25) < 1e-6


def test_sparser_scan_coarser_grid():
    dense, sparse = _scan(20_000), _scan(1_000)
    cfg_d, cfg_s = tuning.suggest_grid(dense), tuning.suggest_grid(sparse)
    assert tuning.estimate_spacing(sparse) > tuning.estimate_spacing(dense)
    assert cfg_s.resolution > cfg_d.resolution
    assert cfg_d.resolution >= 0.2 and cfg_s.resolution <= 2.0
    assert tuning.suggest_grid(sparse, aggressive=True).nearby == 7


def test_suggested_grid_supports_plane_fits():
    """On a decimated scan the suggestion gives > 90 % of the points their
    5 neighbours through the port's voxel map."""
    scan = _scan(1_500, seed=3)
    cfg = tuning.suggest_grid(scan, capacity=1 << 14)
    pts = torch.from_numpy(np.ascontiguousarray(scan.T))
    mask = torch.ones(len(scan), dtype=torch.bool)
    grid = ops.insert(cfg, ops.create(cfg, device="cpu"), pts, mask)
    _, _, cnt, _ = ops.knn(cfg, grid, pts, k=5, max_range=3.0 * cfg.resolution)
    frac = float((cnt >= 5).float().mean())
    assert frac > 0.9, f"only {frac:.2%} of points have 5 neighbors (res {cfg.resolution})"


@pytest.mark.parametrize("n, aggressive, masked", [(20_000, False, False), (1_000, False, True),
                                                   (3_000, True, False)])
def test_suggest_grid_matches_jax(n, aggressive, masked):
    """The same scan (as (N, 3) numpy, or (3, N) tensor + mask on the port)
    gives the JAX package's GridConfig field for field."""
    scan = _scan(n, seed=5)
    mask = np.random.default_rng(1).uniform(size=n) < 0.7 if masked else None
    cfg_j = tuning_j.suggest_grid(scan, mask, capacity=1 << 16, aggressive=aggressive)
    pts = torch.from_numpy(np.ascontiguousarray(scan.T))
    cfg_t = tuning.suggest_grid(pts, None if mask is None else torch.from_numpy(mask), capacity=1 << 16,
                                aggressive=aggressive)
    assert dataclasses.asdict(cfg_t) == {f: getattr(cfg_j, f) for f in dataclasses.asdict(cfg_t)}


class TestTimer:
    def test_evaluate_and_dump(self, tmp_path):
        Timer.reset()
        out = Timer.evaluate(lambda: torch.ones(8).sum(), "stage_a")
        assert float(out) == 8.0
        Timer.record("stage_b", 1.5)
        Timer.record("stage_b", 2.5)
        assert abs(Timer.mean("stage_b") - 2.0) < 1e-9
        path = str(tmp_path / "times.csv")
        Timer.dump_into_file(path)
        lines = open(path).read().strip().splitlines()
        assert lines[0] == "stage_a,stage_b"
        assert len(lines) == 3
        plot = _load("apps/plot_timings.py", "plot_timings")
        cols = plot.read_timer_csv(path)
        assert cols["stage_b"].tolist() == [1.5, 2.5] and len(cols["stage_a"]) == 1
        Timer.reset()

    def test_print_all(self, capsys):
        Timer.reset()
        for ms in (1.0, 3.0):
            Timer.record("s", ms)
        Timer.print_all()
        row = capsys.readouterr().out.strip().splitlines()[1].split()
        assert row == ["s", "2", "2.000", "4.0"]
        Timer.reset()


class TestLogging:
    def test_glog_prefix_and_levels(self, capsys):
        lg = log.get_logger("test_torch")
        lg.info("hello")
        lg.warning("watch out")
        err = capsys.readouterr().err.splitlines()
        assert err[0].startswith("I") and err[0].endswith("pcs.test_torch] hello")
        assert err[1].startswith("W") and "watch out" in err[1]

    def test_debug_channels(self, tmp_path):
        dbg = log.DebugChannels(str(tmp_path), enabled=["effect_points"])
        dbg.publish("loop_constraints", 0, pairs=np.zeros((2, 2)))
        dbg.publish("effect_points", 3, pts=torch.ones((3, 4)))
        dbg.close()
        files = sorted(f.name for f in tmp_path.iterdir())
        assert files == ["effect_points_000000.npz"]
        with np.load(tmp_path / files[0]) as z:
            assert int(z["_frame"]) == 3 and z["pts"].shape == (3, 4)


def test_mapping_app_auto_grid_and_time_log(tmp_path, capsys):
    """--auto_grid sizes the grid from the first frame, --time_log_file
    writes one lio_step time a frame that plot_timings reads."""
    mapping = _load("apps/run_mapping_offline_torch.py", "rmo_torch_timer")
    csv = str(tmp_path / "time.csv")
    mapping.main(["--synthetic", "6", "--n_points", "2000", "--device", "cpu", "--auto_grid",
                  "--traj_log_file", str(tmp_path / "traj.txt"), "--time_log_file", csv])
    out = capsys.readouterr().out
    assert "auto_grid: resolution" in out and "frames: 6" in out
    cols = _load("apps/plot_timings.py", "plot_timings_app").read_timer_csv(csv)
    assert list(cols) == ["lio_step"] and len(cols["lio_step"]) == 6 and (cols["lio_step"] > 0).all()
    traj = np.loadtxt(tmp_path / "traj.txt")
    assert traj.shape == (6, 8) and np.isfinite(traj).all()
