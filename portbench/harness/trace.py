"""What a traced run reads from `torch.profiler` and the CUDA sync debugger.

`count_syncs` is a copy of `chip_smoke.py::count_syncs` at commit 9c22c1c.
`profile_frames` follows `chip_smoke.py::profile_launches` (launch calls by
the CUDA runtime's launch entry points, device time by operation) and
changes what it sums: the device's busy time is the union of the intervals
in which any device operation ran, not the sum of their self times (two
operations that overlap count once), and launches are counted inside the
harness's span around each pipeline call only, so the harness's own pose
read is not charged to the pipeline.
"""

from __future__ import annotations

import bisect
import time
import warnings
from typing import Callable

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
CALL_SPAN = "portbench.call"        # record_function label around each pipeline call
READ_SPAN = "portbench.pose_read"   # ... and around the pose's read to the host
PROFILER_OWN = ("Activity Buffer Request",)   # the profiler's own host work


def count_syncs(fn: Callable):
    """fn() under the CUDA sync debugger: (its result, synchronizing ops seen).
    The caller reads the result afterwards, outside the count."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def merged(intervals):
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    return sum(e - s for s, e in merged(intervals))


def _events(prof):
    """(device events, host events) of a finished profile as plain tuples
    (name, start_ns, end_ns); device events are the operations the CUDA
    activity tracer recorded (kernels, copies, sets), without the device
    timeline's copies of host annotations."""
    import torch

    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        rec = (ev.name(), s, s + ev.duration_ns())
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            host.append(rec)
        elif not ev.is_user_annotation() and rec[0] not in (CALL_SPAN, READ_SPAN):
            dev.append(rec)     # the device timeline's copy of a host span is no device work
    return dev, host


def gap_labels(gaps, host, top=10):
    """Label each idle gap (start, end) by what the host was doing at its
    middle: the innermost host event that spans it (host events nest, so a
    stack swept along the time axis finds it), else "host: none". Returns
    the top labels by total idle seconds, as [[label, seconds], ...]."""
    host = sorted(host, key=lambda h: h[1])
    by_label, stack, k = {}, [], 0
    for s, e in sorted(gaps):
        mid = 0.5 * (s + e)
        while k < len(host) and host[k][1] <= mid:
            stack.append(host[k])
            k += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        label = stack[-1][0] if stack else "host: none"
        by_label[label] = by_label.get(label, 0.0) + (e - s) * 1e-9
    return [[k_, v] for k_, v in sorted(by_label.items(), key=lambda kv: -kv[1])[:top]]


def profile_frames(run_frames: Callable[[], int], kernel_patterns: dict):
    """Run `run_frames()` (which hands in frames and returns how many) under
    torch.profiler. Returns a dict: frames, window_s (host wall of the
    traced frames), busy_s (union of device-operation intervals), launches
    (CUDA launch calls inside the harness's call spans), device_ops (top 10
    [name, seconds] by device time), idle_gaps (top 10 [host label,
    seconds] of the gaps between device work), and kernels: for each name
    of `kernel_patterns` ({metric name: substring of the kernel's name}),
    the device durations in seconds of the matching records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = run_frames()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, host = _events(prof)
    calls = [(s, e) for name, s, e in host if name == CALL_SPAN]
    launches = 0
    calls.sort()
    call_starts = [c[0] for c in calls]
    for name, s, _ in host:
        if name in LAUNCH_CALLS:
            i = bisect.bisect_right(call_starts, s) - 1
            if i >= 0 and s <= calls[i][1]:
                launches += 1
    ivals = [(s, e) for _, s, e in dev]
    busy_ns = union_length(ivals)
    # the traced window on the profiler's clock: from the first call span's start to the last event's end
    lo = min([c[0] for c in calls] + [s for _, s, _ in dev]) if (calls or dev) else 0
    hi = max([e for _, _, e in dev] + [c[1] for c in calls]) if (calls or dev) else 0
    m = merged(ivals)
    gaps = [(a[1], b[0]) for a, b in zip(m, m[1:]) if b[0] > a[1]]
    if m:
        if m[0][0] > lo:
            gaps.append((lo, m[0][0]))
        if hi > m[-1][1]:
            gaps.append((m[-1][1], hi))
    by_op = {}
    for name, s, e in dev:
        by_op[name] = by_op.get(name, 0.0) + (e - s) * 1e-9
    device_ops = [[k[:120], v] for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])[:10]]
    kernels = {key: [(e - s) * 1e-9 for name, s, e in dev if pat in name] for key, pat in kernel_patterns.items()}
    return dict(frames=n, window_s=wall, busy_s=busy_ns * 1e-9, launches=launches, device_ops=device_ops,
                idle_gaps=gap_labels(gaps, [h for h in host if h[0] not in LAUNCH_CALLS + PROFILER_OWN]),
                kernels=kernels,
                device_events=len(dev))
