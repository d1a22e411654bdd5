"""The port's online product paths on the CPU: `apps/run_mapping_online_torch.py`
(its frames against the JAX package's native ingest shim, and its tracking),
`tools/soak_online_torch.py` and `tools/soak_localization_torch.py` for a few
seconds each, their JSON lines parsed and held to the LIO / localization
gates."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

from pointcloud_slam_tpu import native as jnative
from pointcloud_slam_tpu_torch.io import synthetic as tsyn
from pointcloud_slam_tpu_torch.models import lio as tlio

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(args, timeout=240):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, *args], cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_online_mapper_frames_equal_jax_ingest():
    """The event stream of both apps is the same, and the frames the port's
    OnlineMapper hands to its step equal, field for field, the frames the JAX
    package's native IngestShim assembles from the same events."""
    port = _load("apps/run_mapping_online_torch.py", "online_port")
    jax_app = _load("apps/run_mapping_online.py", "online_jax")
    n_frames, n_pts, n_imu = 6, 2048, 32
    events = list(port.synthetic_stream(n_frames, n_pts=n_pts))
    for a, b in zip(events, jax_app.synthetic_stream(n_frames, n_pts=n_pts), strict=True):
        assert a[0] == b[0] and all(np.array_equal(x, y) for x, y in zip(a[1:], b[1:]))

    captured = []

    class Capture:          # the mapper's step, replaced by a recorder
        LIOFrame = tlio.LIOFrame

        @staticmethod
        def lio_step(cfg, s, frame):
            captured.append(frame)
            return s, None

    mapper = port.OnlineMapper(n_points=n_pts, n_imu=n_imu, device="cpu")
    mapper.lio = Capture
    shim = jnative.IngestShim(n_pts, n_imu)
    want, pending = [], None
    for ev in events:
        if ev[0] == "imu":
            mapper.push_imu(*ev[1:])
            shim.push_imu(np.atleast_1d(ev[1]), np.atleast_2d(ev[2]), np.atleast_2d(ev[3]))
        else:
            mapper.push_scan(*ev[1:])
            pending = ev[1:]
        if pending is not None:
            raw = shim.make_frame(*pending, blind=0.3, filter_num=1)
            if raw is not None:
                want.append(raw)
                pending = None
    assert mapper.n_frames == len(captured) == len(want) == n_frames
    for got, raw in zip(captured, want):
        for field in tlio.LIOFrame._fields:
            np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(raw[field]), err_msg=field)


def test_online_mapper_tracks(tmp_path, capsys):
    """8 frames at 2,048 points through the app: the streamed poses within the
    LIO gates of tests/test_lio.py (from frame 5: final < 0.25 m, mean < 0.2 m)
    of the stream's trajectory."""
    traj_file = tmp_path / "online.txt"
    _load("apps/run_mapping_online_torch.py", "online_app").main(
        ["--frames", "8", "--n_points", "2048", "--device", "cpu", "--traj_log_file", str(traj_file)])
    assert "8 frames in" in capsys.readouterr().out
    est = np.loadtxt(traj_file)[:, 1:4]
    traj = tsyn.make_imu_trajectory(8, 20, 0.1, seed=0)
    gt = traj["pos"][20::20][:8]
    err = np.linalg.norm(est - (gt - gt[0]), axis=1)[5:]
    assert err[-1] < 0.25 and err.mean() < 0.2, err


def test_soak_online_runs_on_cpu():
    """The live-driver soak for 2.5 s of stream at 0.8 x real time: every frame
    arrives or is counted as dropped, the queue and latency fields are
    reported, and the trajectory stays within the LIO gates."""
    res = json.loads(_run(["tools/soak_online_torch.py", "--seconds", "2.5", "--time_scale", "0.8", "--n_points",
                           "2048", "--device", "cpu"]).strip().splitlines()[-1])   # its CLI, in a process of its own
    assert res["frames"] + res["dropped"] == 25 and res["frames"] >= 10, res
    assert set(res["latency_ms"]) == {"p50", "p90", "p99", "max"} and res["queue_depth"]["max"] >= 0
    assert res["ate_mean_m"] < 0.2 and res["ate_final_m"] < 0.25, res


def test_soak_localization_runs_on_cpu(capsys):
    """The localization soak for 2 s at 10 Hz: the injected loss is detected
    and recovered, and the final error is < 0.10 m."""
    _load("tools/soak_localization_torch.py", "soak_loc").main(["--seconds", "2", "--device", "cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["frames"] == 20 and res["losses"] == 1 and res["recoveries"] == 1, res
    assert res["err_final_m"] < 0.10 and res["latency_p50_ms"] > 0, res
