#!/usr/bin/env python
"""The split of a benchmark cell's traced frames by the program's spans, on the card.

Runs one cell as `python portbench/run.py --trace 1` does (the harness's
result line is printed first), keeps the profile of its traced frames, and
prints one more JSON line. For each span of `utils/timer.Timer` (and the
harness's own spans around the call and the pose read) over the traced
frames, a frame: the host self time in ms (the Timer's records), the CUDA
launches and the device ms (each launch, and its device record, charged to
the innermost span around the launch), and the launches whose device record
the profiler did not keep (`lost`, in all). Also the counts a frame (for
NDT always `ndt.graph_replays` and `ndt.graph_captures`), how far a frame's
summed self times lie from its root span on the profiler's clock
(`root_gap_pct`, the largest over the frames), and the NDT graphs the whole
run left in `register.ndt`'s cache (`ndt_graphs`: keys, and those captured;
a capture happens once, in set-up, outside the traced frames).

    python tools/span_split_torch.py --workload loc_ndt_rs16.hall_laps --seed 3000000001 --seconds 10
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def innermost(points, intervals):
    """For each point time, the label of the innermost (start, end, label)
    interval around it (intervals nest), else None."""
    iv = sorted(intervals)
    out, stack, k = [None] * len(points), [], 0
    for i in sorted(range(len(points)), key=points.__getitem__):
        t = points[i]
        while k < len(iv) and iv[k][0] <= t:
            stack.append(iv[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = stack[-1][2] if stack else None
    return out


def split(prof, frames, call_name):
    import torch

    from portbench.harness.trace import CALL_SPAN, LAUNCH_CALLS, READ_SPAN

    frames = [f for f in frames if f.root == call_name]
    n = max(len(frames), 1)
    names = {s.name for f in frames for s in f.spans} | {CALL_SPAN, READ_SPAN}
    spans, launches, device = [], [], {}
    for ev in prof.profiler.kineto_results.events():
        s, e = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if not ev.is_user_annotation() and ev.name() not in names:
                device[ev.correlation_id()] = (ev.name(), e - s)
        elif ev.name() in names:
            spans.append((s, e, ev.name()))
        elif ev.name() in LAUNCH_CALLS:
            launches.append((s, ev.correlation_id()))
    labels = innermost([t for t, _ in launches], spans)
    by = {}
    for label, (_, corr) in zip(labels, launches):
        row = by.setdefault(label or "none", {"launches": 0, "device_ms": 0.0, "lost": 0})
        row["launches"] += 1
        if corr in device:
            row["device_ms"] += device[corr][1] * 1e-6
        else:
            row["lost"] += 1
    for row in by.values():
        row["launches"] /= n
        row["device_ms"] /= n
    roots = sorted((s, e) for s, e, name in spans if name == call_name)
    gaps = [abs(sum(f.self_ms.values()) - (e - s) * 1e-6) / ((e - s) * 1e-6) for f, (s, e) in zip(frames, roots)]
    host = {}
    for f in frames:
        for name, ms in f.self_ms.items():
            host[name] = host.get(name, 0.0) + ms / n
    counts = {}
    if call_name == "localize_ndt":
        counts = {"ndt.graph_replays": 0.0, "ndt.graph_captures": 0.0}
    for f in frames:
        for name, c in f.counts.items():
            counts[name] = counts.get(name, 0.0) + c / n
    eig_spans = sum(name == "ndt.eig" for _, _, name in spans)
    k6 = sum(name.find("small_eigh_kernel") >= 0 for name, _ in device.values())
    return {"frames": len(frames), "host_ms": host, "counts": counts, "by_span": by,
            "root_gap_pct": 100.0 * max(gaps, default=0.0), "roots_profiled": len(roots),
            "launches": len(launches), "device_records": len(device),
            "k6": {"ndt_eig_spans": eig_spans, "small_eigh_records": k6}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0, help="the measured window before the traced frames")
    args = p.parse_args(argv)

    from portbench import run as pb_run   # sets the kernel caches' paths first
    from portbench.harness import core
    from portbench.harness import trace as tr
    from pointcloud_slam_tpu_torch.utils.timer import Timer

    kept, events = {}, tr._events

    def keep(prof):
        kept["prof"] = prof
        return events(prof)

    tr._events = keep
    rc = pb_run.main(["--workload", args.workload, "--seed", str(args.seed), "--seconds", str(args.seconds),
                      "--trace", "1"])
    if rc or "prof" not in kept:
        return rc or 1
    from pointcloud_slam_tpu_torch.register import ndt

    out = dict(cell=args.workload, seed=args.seed,
               **split(kept["prof"], Timer.frames(), core.resolve(args.workload).pipeline.CALL_NAME),
               ndt_graphs={"keys": len(ndt._graphs), "captured": sum(e.graph is not None for e in ndt._graphs.values())})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
