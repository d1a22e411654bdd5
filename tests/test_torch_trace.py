"""The port's spans and counts (`utils/timer.Timer`): self times, parents
and frame ids; the off path; every span of a LIO frame and of an NDT
localization frame under torch.profiler, nested in the caller's
`record_function`; the same bits with tracing on and off; the lazy NDT
count; and on the card (marker `cuda`), no synchronization from spans or
counts. Small sizes: the file runs in a few seconds on the CPU and imports
no JAX, so it also runs on a card with `--noconftest`."""

import warnings
import weakref

import numpy as np
import pytest
import torch

from pointcloud_slam_tpu_torch import ops, register
from pointcloud_slam_tpu_torch.geom import se3
from pointcloud_slam_tpu_torch.io import synthetic
from pointcloud_slam_tpu_torch.models import lio
from pointcloud_slam_tpu_torch.models.localization import pipeline as loc
from pointcloud_slam_tpu_torch.utils.timer import Timer

torch.set_num_threads(2)

LIO_SPANS = {"lio_step", "lio_step.propagate", "lio_step.undistort", "lio_step.downsample", "lio_step.update",
             "lio_step.residuals", "lio_step.knn", "lio_step.plane_fit", "lio_step.insert"}
NDT_SPANS = {"localize_ndt", "ndt.align", "ndt.search", "ndt.linearize", "ndt.solve", "ndt.eig",
             "localize_ndt.gate"}
# each span name and the span it lies in
LIO_PARENTS = {"lio_step.propagate": "lio_step", "lio_step.undistort": "lio_step", "lio_step.downsample": "lio_step",
               "lio_step.update": "lio_step", "lio_step.residuals": "lio_step.update",
               "lio_step.knn": "lio_step.residuals", "lio_step.plane_fit": "lio_step.residuals",
               "lio_step.insert": "lio_step"}
NDT_PARENTS = {"ndt.align": "localize_ndt", "ndt.search": "ndt.align", "ndt.linearize": "ndt.align",
               "ndt.solve": "ndt.align", "ndt.eig": "ndt.align", "localize_ndt.gate": "localize_ndt"}


@pytest.fixture(autouse=True)
def timer_off():
    Timer.enable(False)
    Timer.reset()
    yield
    Timer.enable(False)
    Timer.reset()


def _lio_run(device="cpu", n_frames=3):
    """A small LIO walk: (config, frames). The first frame initializes the
    IMU and seeds the map; the next ones run the iterated update."""
    cfg = lio.LIOConfig(grid=ops.GridConfig(capacity=1 << 14, pts_per_voxel=8, resolution=0.4, nearby=7),
                        scan_leaf=0.3, map_leaf=0.3, scan_budget=2048, insert_budget=2048)
    _, _, frames = synthetic.simulate_lio_sequence(n_frames=n_frames, n_pts=1500, seed=0, device=device)
    return cfg, [f for f, _, _ in frames]


def _walk(cfg, frames, device="cpu"):
    s, outs = lio.create_state(cfg, device=device), []
    for fr in frames:
        s, out = lio.lio_step(cfg, s, fr)
        outs.append(out)
    return s, outs


@pytest.fixture(scope="module")
def ndt_room():
    """A 3,000-point room as a baked NDT target and a raw point map, and an
    800-point scan from a pose a few centimetres off."""
    world = synthetic.make_room_cloud(3000, seed=0)
    cfg = loc.LocalizationConfig(method="ndt")
    ndt_cfg, ndt_map = register.ndt.build_target(cfg.ndt, torch.from_numpy(np.ascontiguousarray(world.T)),
                                                 baked=True)
    pt_cfg = ops.GridConfig(capacity=1 << 13, pts_per_voxel=8, resolution=1.0, nearby=7)
    pt_map = ops.insert(pt_cfg, ops.create(pt_cfg, device="cpu"), torch.from_numpy(np.ascontiguousarray(world.T)),
                        torch.ones(len(world), dtype=torch.bool))
    R, t = synthetic.random_pose(seed=1, rot_scale=0.02, trans_scale=0.1)
    scan = torch.from_numpy(np.ascontiguousarray(((world[:800] - t) @ R).astype(np.float32).T))
    return cfg, ndt_cfg, ndt_map, pt_cfg, pt_map, scan


def _localize(room):
    cfg, ndt_cfg, ndt_map, pt_cfg, pt_map, scan = room
    return loc.localize_ndt(cfg, ndt_cfg, ndt_map, pt_cfg, pt_map, scan, torch.ones(scan.shape[1], dtype=torch.bool),
                            se3.identity())


def _self_times(frame):
    """Each name's duration less its child spans', from the spans alone."""
    out = {}
    for s in frame.spans:
        d = s.end_ns - s.start_ns
        out[s.name] = out.get(s.name, 0) + d
        if s.parent >= 0:
            out[frame.spans[s.parent].name] -= d
    return {n: ns * 1e-6 for n, ns in out.items()}


def test_nested_spans_self_times_parents_and_frame_ids():
    Timer.enable()
    for _ in range(2):
        with Timer.span("root"):
            with Timer.span("a"):
                with Timer.span("b"):
                    Timer.count("n", 2)
                with Timer.span("b"):
                    pass
            with Timer.span("a"):
                Timer.count("n")
    Timer.evaluate(lambda: None, "alone")
    frames = Timer.frames()
    assert [f.id for f in frames] == [0, 1, 2] and [f.root for f in frames] == ["root", "root", "alone"]
    for f in frames[:2]:
        assert [s.name for s in f.spans] == ["root", "a", "b", "b", "a"]
        assert [s.parent for s in f.spans] == [-1, 0, 1, 1, 0]
        assert all(s.start_ns <= s.end_ns for s in f.spans)
        assert f.counts == {"n": 3}
        assert f.self_ms.keys() == {"root", "a", "b"}
        for name, ms in _self_times(f).items():
            assert f.self_ms[name] == pytest.approx(ms, rel=1e-9, abs=1e-9)
        assert sum(f.self_ms.values()) == pytest.approx(f.ms, rel=1e-9)
    assert len(Timer._records["root"]) == 2 and len(Timer._records["alone"]) == 1
    assert Timer.mean("b") == pytest.approx(np.mean([f.self_ms["b"] for f in frames[:2]]))


def test_off_records_nothing_and_holds_no_tensor():
    t = torch.ones(3)
    ref = weakref.ref(t)
    with Timer.span("root"):
        with Timer.span("inner"):
            Timer.count("n")
            Timer.count_lazy("m", t)
    assert Timer.span("x") is Timer.span("y")       # the shared no-op
    del t
    assert ref() is None
    assert Timer.frames() == [] and not Timer._records


def _host_spans(prof, names):
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA and ev.name() in names:
            out.append((ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    return out


def _check_nesting(spans, parents, root):
    """Every span lies inside some span of its parent's name, the root inside
    the caller's record_function."""
    (caller,) = [s for s in spans if s[0] == "caller"]
    for name, s, e in spans:
        outer = "caller" if name == root else parents.get(name)
        if outer is None:
            continue
        assert any(p == outer and ps <= s and e <= pe for p, ps, pe in spans), (name, outer)
    assert all(caller[1] <= s and e <= caller[2] for _, s, e in spans)


def test_lio_and_ndt_frames_emit_every_span_under_the_profiler(ndt_room):
    from torch.profiler import ProfilerActivity, profile

    cfg, frames = _lio_run()
    s, _ = _walk(cfg, frames[:2])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("caller"):
            lio.lio_step(cfg, s, frames[2])
        with torch.profiler.record_function("caller_ndt"):
            _localize(ndt_room)
    lio_spans = _host_spans(prof, LIO_SPANS | {"caller"})
    assert {n for n, _, _ in lio_spans} == LIO_SPANS | {"caller"}
    _check_nesting(lio_spans, LIO_PARENTS, "lio_step")
    ndt_spans = [("caller" if n == "caller_ndt" else n, s_, e) for n, s_, e in
                 _host_spans(prof, NDT_SPANS | {"caller_ndt"})]
    assert {n for n, _, _ in ndt_spans} == NDT_SPANS | {"caller"}
    _check_nesting(ndt_spans, NDT_PARENTS, "localize_ndt")
    # the same frames in the Timer, one each, with their counts
    f_lio, f_ndt = Timer.frames()
    assert (f_lio.root, f_ndt.root) == ("lio_step", "localize_ndt")
    assert f_lio.self_ms.keys() == LIO_SPANS and f_ndt.self_ms.keys() == NDT_SPANS
    assert 1 <= f_lio.counts["lio_step.searches"] <= f_lio.counts["lio_step.iterations"] <= cfg.max_iterations
    assert 0 < f_ndt.counts["ndt.iterations_used"] <= f_ndt.counts["ndt.iterations"]
    assert sum(f_ndt.self_ms.values()) == pytest.approx(f_ndt.ms, rel=1e-9)


def _equal_trees(a, b):
    la, lb = torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def test_tracing_on_and_off_give_the_same_bits(ndt_room):
    cfg, frames = _lio_run(n_frames=4)
    off = _walk(cfg, frames)
    Timer.enable()
    on = _walk(cfg, frames)
    _equal_trees(off, on)
    assert len(Timer.frames()) == 4
    Timer.enable(False)
    loc_off = _localize(ndt_room)
    Timer.enable()
    _equal_trees(loc_off, _localize(ndt_room))


def test_lazy_ndt_iterations_used_equals_the_result(ndt_room):
    cfg, ndt_cfg, ndt_map, _, _, scan = ndt_room
    Timer.enable()
    res = register.ndt.align(ndt_cfg, ndt_map, scan, None, se3.identity(), cfg=cfg.ndt)
    (f,) = Timer.frames()
    scfg = cfg.ndt.solver
    rounds = -(-(scfg.max_iterations - cfg.ndt.warmup_searches) // cfg.ndt.search_every)
    assert f.root == "ndt.align"
    assert f.counts == {"ndt.iterations": cfg.ndt.warmup_searches + rounds * cfg.ndt.search_every,
                        "ndt.iterations_used": int(res.iterations)}


@pytest.mark.cuda
def test_spans_and_counts_add_no_sync_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    cfg, frames = _lio_run(device=dev)
    s, _ = _walk(cfg, frames[:2], device=dev)

    def syncs(fn):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return sum("synchroniz" in str(w.message) for w in caught)

    a = torch.randn(256, 256, device=dev)
    positive = []

    def small():
        with Timer.span("root"):
            with Timer.span("mm"):
                b = a @ a
            Timer.count("n")
            positive.append((b > 0).sum())
            Timer.count_lazy("m", positive[-1])

    syncs(small)                                     # the debugger's first switch warns once by itself
    seen = {}
    for on in (False, True):
        Timer.enable(on)
        seen[on] = (syncs(small), syncs(lambda: lio.lio_step(cfg, s, frames[2])))
    assert seen[False][0] == seen[True][0] == 0
    assert seen[False][1] == seen[True][1]           # the step's own convergence reads, no more
    counts = [f.counts for f in Timer.frames()]
    assert counts[0]["n"] == 1 and counts[0]["m"] == int(positive[-1])
    assert counts[1]["lio_step.iterations"] >= 1

