"""`correct` on small CPU runs of each cell: the port against the plain
reference comes out correct; the same run with the timed path broken
underneath (a step that returns its state unchanged, half the sweep left
out, an answer altered where it is produced) and the precision controls come
out not correct. The precision controls (the reference with its float32
matrix products in TF32, and for LIO with its float64 update in float32)
exist only on the card: their cases run at the cells' own sizes on three
seeds (`python -m pytest portbench/tests -m cuda`) and skip without a card.
No cell needs an exchange between chips, so that fault has no case."""

import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.harness import core  # noqa: E402

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SIZES = {   # a sweep of a few thousand points and a short set-up, so that a run takes seconds on the CPU
    "lio": {"config.sensor.columns": 240, "config.setup_laps": 0, "config.setup_sweeps": 20,
            "config.check_sweeps": 40},
    "loc_ndt": {"config.sensor.columns": 600, "config.n_points": 2048, "config.setup_sweeps": 3},
}


def _cpu_run(name, impl="program", seed=2 ** 33 + 17, seconds=2.0):
    torch.set_num_threads(4)
    cell = core.resolve(name)
    return core.run_cell(cell, seed, seconds, False, torch.device("cpu"), time.perf_counter(), impl=impl,
                         sizes=SIZES[cell.config["pipeline"]])


@pytest.mark.parametrize("name", CELLS)
def test_the_port_matches_the_reference_on_the_cpu(name):
    out = _cpu_run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 5 and out["failed"] == 0
    assert out["info"]["frames_compared"] >= 6


def _lio_faults():
    from pointcloud_slam_tpu_torch.models.lio import pipeline as lp

    def unchanged(step):
        def f(s, fr):
            z = torch.zeros((), device=s.P.device)
            return s, lp.LIOOutput(s.x.pos, s.x.rot, s.x.vel, z.int(), z.bool(), torch.diagonal(s.P))
        return f

    def half(step):
        return lambda s, fr: step(s, fr._replace(pt_mask=fr.pt_mask & (torch.arange(fr.pt_mask.numel(), device=fr.pt_mask.device) % 2 == 0)))

    def altered(step):
        def f(s, fr):
            st, o = step(s, fr)
            return st._replace(x=st.x._replace(pos=st.x.pos + 1e-3)), o._replace(pos=o.pos + 1e-3)
        return f

    return {"unchanged": unchanged, "half": half, "altered": altered}


def _ndt_faults():
    from pointcloud_slam_tpu_torch.geom import se3

    def unchanged(step):
        def f(init, pts, mask):
            res, _ = step(init, pts, mask)
            return res._replace(pose=init), init
        return f

    def half(step):
        return lambda init, pts, mask: step(init, pts, mask & (torch.arange(mask.numel(), device=mask.device) % 2 == 0))

    def altered(step):
        def f(init, pts, mask):
            res, _ = step(init, pts, mask)
            pose = se3.Pose(res.pose.R, res.pose.t + 1e-3)
            return res._replace(pose=pose), pose
        return f

    return {"unchanged": unchanged, "half": half, "altered": altered}


FAULTS = {"lio": _lio_faults, "loc_ndt": _ndt_faults}


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    """The fault is planted when the window opens, under the harness's drive
    of the frames, so set-up is sound and every window frame is broken."""
    cell = core.resolve(name)
    system = cell.pipeline.System
    opened = system.window_open

    def window_open(self, rng):
        opened(self, rng)
        self.step = FAULTS[cell.config["pipeline"]]()[fault](self.step)

    monkeypatch.setattr(system, "window_open", window_open)
    out = _cpu_run(name)
    assert not out["correct"], out["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the precision control is read at the cell's own size")
    return torch.device("cuda", 0)


CONTROLS = {   # the reference in the program's place, one step below each precision the configuration states
    "lio": ["control", "control_f32_update"],      # float32 products in TF32; the float64 update in float32
    "loc_ndt": ["control"],                        # float32 products in TF32
}


@pytest.mark.cuda
@pytest.mark.parametrize("name,impl", [(n, i) for n in CELLS
                                       for i in CONTROLS[core.resolve(n).config["pipeline"]]])
def test_the_precision_control_is_not_correct_on_the_card(name, impl, card):
    cell = core.resolve(name)
    for seed in (2 ** 33 + 101, 2 ** 33 + 102, 2 ** 33 + 103):
        out = core.run_cell(cell, seed, 4.0, False, card, time.perf_counter(), impl=impl)
        print(json.dumps({"cell": name, "impl": impl, "seed": seed, "checks": out["checks"]}))
        assert not out["correct"], out["checks"]
