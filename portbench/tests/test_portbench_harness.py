"""The harness's own parts on the CPU: argument parsing, cells found by name,
the traffic generator, the metric arithmetic, the JAX guard, and a run
without a card. Run with `python -m pytest portbench/tests -q`."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import run as run_py  # noqa: E402
from portbench.harness import core, roofline, world  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_arguments_parse():
    a = run_py.parse(["--workload", "x", "--seed", str(2 ** 33 + 5), "--seconds", "10", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == ("x", 2 ** 33 + 5, 10.0, 1)
    with pytest.raises(SystemExit):
        run_py.parse(["--workload", "x", "--seed", "1", "--seconds", "1", "--trace", "2"])


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(name):
    cell = core.resolve(name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert (cell.spec["config"], cell.spec["traffic"], cell.spec["chips"]) == (
        entry["config"], entry["traffic"], entry["chips"])
    assert cell.config["name"] == entry["config"] and cell.traffic["name"] == entry["traffic"]
    assert cell.spec["why"] == entry["why"]
    e2e = [m["name"] for m in BENCH["end_to_end"] if name in m.get("workloads", CELLS)]
    per_layer = [m["name"] for m in BENCH["per_layer"] if name in m.get("workloads", CELLS)]
    assert sorted(cell.spec["end_to_end"]) == sorted(e2e)
    assert sorted(cell.spec["per_layer"]) == sorted(per_layer)
    units = {m["name"]: m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    for m, reader in cell.metrics.items():
        assert reader.UNIT == units[m]
    assert set(cell.spec["limits"]) and all(v >= 0 for v in cell.spec["limits"].values())


def test_benchmark_configs_name_their_files():
    for c in BENCH["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert sorted(data["reduced"]) == sorted(c["reduced"])


def test_a_new_cell_is_new_files_only(tmp_path):
    """A copy of the benchmark's folder takes a new cell, traffic mix (with a
    generator of its own) and metric as new files, and the harness finds them
    with no edit."""
    root = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", root, ignore=shutil.ignore_patterns("__pycache__"))
    (root / "generators" / "hall_lap_twice.py").write_text(
        "from portbench.generators.hall_lap import *  # noqa: F401,F403\n"
        "from portbench.generators import hall_lap\n\n\n"
        "def period_s(path):\n    return 2 * hall_lap.period_s(path)\n")
    (root / "traffic" / "slow_laps.json").write_text(json.dumps(
        dict(json.loads((root / "traffic" / "hall_laps.json").read_text()), name="slow_laps", lap_period_s=30.0,
             generator="hall_lap_twice")))
    (root / "metrics" / "frames_total.py").write_text(
        'UNIT = "frames"\n\n\ndef read(run):\n    return len(run.frames)\n')
    spec = dict(json.loads((root / "workloads" / "lio_vlp16.hall_laps.json").read_text()),
                name="lio_vlp16.slow_laps", traffic="slow_laps")
    spec["per_layer"] = spec["per_layer"] + ["frames_total"]
    (root / "workloads" / "lio_vlp16.slow_laps.json").write_text(json.dumps(spec))
    cell = core.resolve("lio_vlp16.slow_laps", root=root)
    assert cell.traffic["lap_period_s"] == 30.0 and "frames_total" in cell.metrics
    assert cell.generator.period_s(cell.generator.path(cell.traffic, 1)) == 60.0
    run = core.Run(cell, 1.0)
    run.frames = [core.Frame(0, 0, 0, 0, True)] * 3
    assert cell.metrics["frames_total"].read(run) == 3


def test_jax_guard_compares_whole_top_level_names():
    names = ["pointcloud_slam_tpu_torch", "pointcloud_slam_tpu_torch.ops.voxel_grid", "pointcloud_slam_tpu",
             "pointcloud_slam_tpu.ops", "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "jaxtyping",
             "numpy", "portbench.harness.core"]
    assert core.forbidden_modules(names) == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
                                             "pointcloud_slam_tpu", "pointcloud_slam_tpu.ops"]


def test_harness_imports_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench.harness import core\n"
            "for n in %r: core.resolve(n)\n"
            "import pointcloud_slam_tpu_torch.models.lio.pipeline, pointcloud_slam_tpu_torch.models.localization.pipeline\n"
            "print(core.forbidden_modules(list(sys.modules)))" % (str(ROOT), CELLS))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload", CELLS[0], "--seed", "7",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=120, env=env,
                         cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "card" in out.stderr


def test_a_run_with_only_the_benchmarks_files_fails(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's folder
    has no system under test: the run fails and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "7", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=120, env=env, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "pointcloud_slam_tpu_torch" in out.stderr


def _traffic():
    return json.loads((ROOT / "portbench" / "traffic" / "hall_laps.json").read_text())


def test_the_generator_is_deterministic_per_seed():
    tr, s = _traffic(), world.Sensor(16, 120, (-15.0, 15.0), 0.5, 0.005, (0.4, 0.0, 0.2))
    w = world.make_box_world(tr["hall_seed"])
    t = torch.arange(3, dtype=torch.float64) * tr["sweep_s"]

    def make(seed):
        gen = torch.Generator().manual_seed(seed)
        return world.sweeps(w, world.make_lap(tr, seed), s, t, tr["sweep_s"], False, gen)

    a, b, c = make(2 ** 33 + 1), make(2 ** 33 + 1), make(2 ** 33 + 2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
    pts, mask, t_offs = a
    assert pts.shape == (3, 3, 16 * 120) and bool(mask.all())
    assert float(t_offs.max()) < tr["sweep_s"]


def test_the_lap_replays_with_no_seam():
    tr = _traffic()
    lap = world.make_lap(tr, 12345)
    n = round(tr["lap_period_s"] / tr["sweep_s"])
    t = torch.tensor([0.0, 0.0025, 0.05, 7.3], dtype=torch.float64)
    for a, b in zip(world.imu_state(lap, t), world.imu_state(lap, t + n * tr["sweep_s"])):
        assert torch.allclose(a, b, atol=1e-9)
    # the last IMU sample of the lap's last sweep and the first of its first are one sample period apart
    starts = torch.arange(n, dtype=torch.float64) * tr["sweep_s"]
    _, _, dt, offs = world.imu_samples(lap, starts, tr["sweep_s"], 20)
    assert torch.allclose(offs[-1], offs[0]) and float(offs[0, 0]) == pytest.approx(float(dt[0, 0]))
    assert float(starts[-1] + offs[-1, -1]) == pytest.approx(tr["lap_period_s"])
    # the path is continuous across the seam and walks about a metre a second, yaw rate within 0.5 rad/s
    ts = torch.linspace(0.0, tr["lap_period_s"], 3001, dtype=torch.float64)
    R, p, acc, gyro = world.imu_state(lap, ts)
    speed = torch.linalg.norm(p[1:] - p[:-1], dim=1) / (ts[1] - ts[0])
    assert 0.6 < float(speed.mean()) < 1.4
    assert float(gyro[:, 2].abs().max()) < 0.52
    assert torch.allclose(torch.linalg.norm(acc, dim=1).mean(), torch.tensor(world.GRAVITY, dtype=torch.float64),
                          atol=0.2)


def test_prior_map_lies_on_the_halls_surfaces():
    w = world.make_box_world(0)
    gen = torch.Generator().manual_seed(3)
    p = world.prior_map(w, 20.0, 0.0, gen, "cpu").double().T
    assert p.shape[0] > 1000
    lo, hi = torch.as_tensor(w[0]), torch.as_tensor(w[1])
    assert bool(((p >= lo - 1e-6) & (p <= hi + 1e-6)).all())


def _run(frames, seconds=2.0, loop="closed"):
    cell = core.resolve(CELLS[0])
    run = core.Run(cell, seconds)
    run.loop = loop
    run.window_start = 0.0
    run.frames = frames
    return cell, run


def test_rate_counts_every_pose_inside_the_whole_window():
    # 5 frames of 0.3 s, the last one's pose after the 2 s window closed
    frames = [core.Frame(0.3 * i, 0.3 * i, 0.3 * i + 0.2, 0.3 * i + 0.3, True) for i in range(7)]
    cell, run = _run(frames)
    assert cell.metrics["frames_per_s"].read(run) == pytest.approx(6 / 2.0)


def test_p95_is_over_every_frame():
    lat = list(range(1, 101))        # ms
    frames = [core.Frame(0.0, 0.0, 0.0, v / 1e3, True) for v in lat]
    cell, run = _run(frames)
    assert cell.metrics["frame_ms_p95"].read(run) == pytest.approx(95.0)
    assert core.p95([5.0]) == 5.0 and core.p95([1.0, 2.0]) == 2.0
    # open loop: timed from when the sweep was due
    frames = [core.Frame(0.1 * i, 0.1 * i + 0.05, 0.1 * i + 0.06, 0.1 * i + 0.08, True) for i in range(20)]
    _, run = _run(frames, loop="open")
    assert cell.metrics["frame_ms_p95"].read(run) == pytest.approx(80.0)


def test_host_spans_and_pose_wait():
    frames = [core.Frame(t, t, t + 0.07, t + 0.075, True) for t in (0.0, 0.1, 0.2)]
    cell, run = _run(frames)
    assert cell.metrics["lio_step.host_ms"].read(run) == pytest.approx(70.0)
    assert cell.metrics["pose_wait_ms"].read(run) == pytest.approx(5.0)
    assert cell.metrics["device_idle_pct"].read(run) is None       # nothing traced
    run.profile = {"window_s": 2.0, "busy_s": 0.3, "frames": 10, "launches": 52000, "kernels": {}}
    # 30 ms busy a traced frame against the unprofiled window's 275 ms over 3 frames, not the traced 200 ms
    assert cell.metrics["device_idle_pct"].read(run) == pytest.approx(100.0 * (1.0 - 0.03 / (0.275 / 3)))
    assert cell.metrics["lio_step.launches"].read(run) == pytest.approx(5200.0)


def test_k6_bound_and_roofline_share():
    t, by = roofline.k6_bound_s(1, 6, 4, False)
    assert by == "bytes" and t == pytest.approx(4 * (36 + 6) / 3.35e12)
    t, by = roofline.k6_bound_s(1000, 8, 8, True)      # 4.2 operations a byte: under the card's balance of 10
    assert by == "bytes" and t == pytest.approx(1000 * 8 * (64 + 8 + 64) / 3.35e12)
    reader = core.load_module("metrics", "k6_roofline")
    cell, run = _run([])
    run.profile = {"kernels": {"k6": [6.5e-6, 6.5e-6]}}
    run.kernel_calls = {"k6": [(1, 6, 4, False)] * 3}
    assert reader.read(run) == pytest.approx(100.0 * roofline.k6_bound_s(1, 6, 4, False)[0] / 6.5e-6)
    run.profile = {"kernels": {"k6": []}}
    assert reader.read(run) is None


def test_union_of_device_intervals():
    from portbench.harness import trace

    assert trace.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
    gaps = [(10, 20), (30, 40)]
    host = [("a", 0, 100), ("b", 5, 25), ("c", 12, 18), ("d", 35, 36)]
    assert trace.gap_labels(gaps, host) == [["c", 1e-8], ["d", 1e-8]]
    assert np.isclose(sum(v for _, v in trace.gap_labels([(0, 5)], [])), 5e-9)
