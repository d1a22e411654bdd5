"""The harness: finds a cell's files by name, drives its frames through the
port, reads its metrics and decides `correct`.

A cell (`workloads/<cell>.json`) names its configuration
(`configs/<config>.json`), its traffic mix (`traffic/<mix>.json`, which
names its generator, `generators/<generator>.py`), its
metrics (`metrics/<metric>.py`, one reader each) and the limits of its
correctness numbers. A configuration names its pipeline
(`pipelines/<pipeline>.py`), which builds the port's objects from the
configuration's values, hands in one sweep at a time and compares what the
port produced with the plain reference (`reference/`). Nothing here names a
cell, a configuration, a mix or a metric: a new one is new files.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import random
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

from .trace import CALL_SPAN, READ_SPAN

PB = Path(__file__).resolve().parent.parent          # the benchmark's folder
FORBIDDEN = ("jax", "jaxlib", "flax", "pointcloud_slam_tpu")   # whole top-level module names
TRACE_FRAMES = 10       # frames under the profiler in a --trace 1 run
SYNC_FRAMES = 3         # frames counted under the CUDA sync debugger after them (after one uncounted)


def load_json(kind: str, name: str, root: Path = PB) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no {kind[:-1]} named {name!r} ({path.relative_to(root.parent)} is missing)")
    return json.loads(path.read_text())


def load_module(kind: str, name: str, root: Path = PB):
    """The module `<root>/<kind>/<name>.py` (names may hold dots)."""
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no {kind[:-1]} named {name!r} ({path.relative_to(root.parent)} is missing)")
    mod_name = f"portbench_{kind}_{name}".replace(".", "_").replace("-", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell(NamedTuple):
    name: str
    spec: dict         # the workload file
    config: dict
    traffic: dict
    generator: object  # the traffic mix's generator module
    pipeline: object   # the pipeline module
    metrics: dict      # metric name -> reader module


def resolve(name: str, root: Path = PB) -> Cell:
    """Everything a cell names, found by name."""
    spec = load_json("workloads", name, root)
    config = load_json("configs", spec["config"], root)
    traffic = load_json("traffic", spec["traffic"], root)
    generator = load_module("generators", traffic["generator"], root)
    pipeline = load_module("pipelines", config["pipeline"], root)
    metrics = {m: load_module("metrics", m, root) for m in spec["end_to_end"] + spec["per_layer"]}
    return Cell(name, spec, config, traffic, generator, pipeline, metrics)


def forbidden_modules(names) -> list:
    """The names in `names` whose top-level name (before the first dot) is,
    whole, one of FORBIDDEN: `pointcloud_slam_tpu_torch.x` passes,
    `pointcloud_slam_tpu.x` and `jax.numpy` do not."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


class Frame(NamedTuple):
    due: float       # when the sweep was due (open loop) or handed in (closed loop), perf_counter seconds
    handed: float    # handed to the pipeline
    returned: float  # the pipeline call returned (its work queued)
    pose: float      # the pose was on the host
    ok: bool         # a pose, finite, and not flagged lost


class Run:
    """What one run recorded, for the metric readers."""

    def __init__(self, cell: Cell, seconds: float):
        self.cell = cell
        self.loop = cell.traffic["loop"]
        self.call_name = cell.pipeline.CALL_NAME
        self.seconds = seconds
        self.window_start = None
        self.frames: list[Frame] = []       # the window's frames
        self.traced: list[Frame] = []       # the profiled frames after the window
        self.setup_s = None
        self.profile = None                 # trace.profile_frames' dict
        self.syncs = None                   # syncs per pipeline call in the traced frames
        self.kernel_calls = {}              # kernel -> [(batch, n, bytes a value, with vectors)] while traced
        self.harness_s = 0.0                # the harness's own host time between frames (after each pose)

    def window_end(self) -> float:
        return self.window_start + self.seconds


def p95(values) -> float:
    """The 95th percentile by nearest rank: the value that 95 % of the
    samples do not exceed."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def drive(system, run: Run, frames: list, n_max=None, profiling=False):
    """Hand frames to the pipeline, closed or open loop, until the window
    closes (or `n_max` frames). Each frame: hand in, let the call return,
    read the pose to the host; the next frame waits for that pose. Open
    loop: frame i is due at window_start + i * period and is handed in at
    its due time or, if the pose before it came later, then."""
    import torch

    period = 1.0 / run.cell.traffic["rate_hz"] if run.loop == "open" else 0.0
    start = time.perf_counter() if n_max is not None else run.window_start
    i = 0
    while True:
        due = start + i * period
        now = time.perf_counter()
        if n_max is None and now >= run.window_end():
            break
        if n_max is not None and i >= n_max:
            break
        if run.loop == "open" and now < due:
            time.sleep(due - now)
        t0 = time.perf_counter()
        with torch.profiler.record_function(CALL_SPAN) if profiling else contextlib.nullcontext():
            out = system.call()
        t1 = time.perf_counter()
        with torch.profiler.record_function(READ_SPAN) if profiling else contextlib.nullcontext():
            pose = system.pose_to_host(out)
        t2 = time.perf_counter()
        ok = system.after(out, pose)
        frames.append(Frame(due if run.loop == "open" else t0, t0, t1, t2, ok))
        run.harness_s += time.perf_counter() - t2
        i += 1
    return i


def host_probe_ms() -> float:
    """Milliseconds the host takes for a fixed piece of pure Python work: a
    reading of the host's speed beside the run's, outside the window."""
    t = time.perf_counter()
    s = 0
    for i in range(200_000):
        s += i
    return 1e3 * (time.perf_counter() - t)


def with_sizes(cell: Cell, sizes: dict):
    """Copies of the cell's configuration and traffic with `sizes` applied:
    {"config.sensor.columns": 120, "traffic.lap_period_s": 3.0, ...}, for
    the CPU tests' small runs."""
    docs = {"config": json.loads(json.dumps(cell.config)), "traffic": json.loads(json.dumps(cell.traffic))}
    for path, value in sizes.items():
        keys = path.split(".")
        d = docs[keys[0]]
        for k in keys[1:-1]:
            d = d[k]
        if keys[-1] not in d:
            raise KeyError(f"no {path} to resize")
        d[keys[-1]] = value
    return docs["config"], docs["traffic"]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_process: float, impl="program",
             sizes=None) -> dict:
    """One run of a cell: set-up, the measured window, with `trace` the
    profiled frames, then the comparison with the reference. Returns the
    result (without `device`'s card fields, which the caller adds).
    `impl` selects what runs in the program's place ("program", or the
    pipeline's precision control "control"); `sizes` (see `with_sizes`)
    shrinks the sweep and the maps for the CPU tests."""
    import torch

    from . import trace as tr

    config, traffic = with_sizes(cell, sizes or {})
    system = cell.pipeline.System(config, traffic, seed, device, impl=impl)
    t_setup = time.perf_counter()
    system.setup()
    if device.type == "cuda":
        torch.cuda.synchronize()
    run = Run(cell, seconds)
    probe_before = host_probe_ms()
    run.window_start = time.perf_counter()
    run.setup_s = run.window_start - t_process
    system.window_open(random.Random(seed ^ 0x5EED))
    drive(system, run, run.frames)
    if device.type == "cuda":
        torch.cuda.synchronize()
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    system.window_close()
    n_window, harness_s = len(run.frames), run.harness_s
    probe_after = host_probe_ms()
    if trace:
        if device.type != "cuda":
            raise RuntimeError("a traced run needs the card")
        probes = system.kernel_probes(run.kernel_calls)
        try:
            run.profile = tr.profile_frames(lambda: drive(system, run, run.traced, n_max=TRACE_FRAMES, profiling=True),
                                            cell.pipeline.KERNELS)
        finally:
            probes()
        counts = []
        # syncs inside the pipeline call, the pose's read outside the count; the first frame under the
        # sync debugger is not counted (the debugger's first switch to "warn" warns once by itself)
        for i in range(SYNC_FRAMES + 1):
            t0 = time.perf_counter()
            out, n = tr.count_syncs(system.call)
            t1 = time.perf_counter()
            pose = system.pose_to_host(out)
            run.traced.append(Frame(t0, t0, t1, time.perf_counter(), system.after(out, pose)))
            if i:
                counts.append(n)
        run.syncs = float(np.mean(counts))
    readings = system.check()
    limits = cell.spec["limits"]
    checks = [(name, readings[name], limits[name]) for name in limits]
    all_frames = run.frames + run.traced
    failed = sum(not f.ok for f in all_frames)
    correct = bool(checks) and all(v <= lim for _, v, lim in checks) and bool(run.frames)
    which = cell.spec["end_to_end"] if not trace else cell.spec["per_layer"]
    metrics = {}
    for name in which:
        reader = cell.metrics[name]
        value = reader.read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": reader.UNIT}
    info = system.info()
    # where set-up went: imports and the card's start, then the system's own parts
    info["setup_parts_s"] = dict(start=t_setup - t_process, **system.setup_parts)
    # frames completed in each fifth of the window: how the rate moved inside it
    fifth = seconds / 5.0
    info["harness_ms_per_frame"] = 1e3 * harness_s / max(n_window, 1)
    info["host_probe_ms"] = [probe_before, probe_after]
    info["rate_fifths"] = [sum(run.window_start + j * fifth < f.pose <= run.window_start + (j + 1) * fifth
                               for f in run.frames) / fifth for j in range(5)]
    out = {"correct": correct, "attempted": len(all_frames), "failed": failed, "metrics": metrics,
           "memory_peak_bytes": memory_peak, "checks": checks, "info": info}
    if trace:
        out["busy_s"] = run.profile["busy_s"]
        out["window_s"] = run.profile["window_s"]
        out["breakdown"] = {"device_ops": run.profile["device_ops"], "idle_gaps": run.profile["idle_gaps"]}
    return out
