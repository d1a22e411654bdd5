"""Per-stage timing registry and the port's spans (port of `pointcloud_slam_tpu/utils/timer.py`).

Behavioral parity target: reference `src/jueying_lio/include/utils.h:18-110`
(`Timer::Evaluate(lambda, name)`, `PrintAll`, `DumpIntoFile` CSV,
`GetMeanTime`) — the per-stage profile `apps/plot_timings.py` reads.

Spans. `Timer.span(name)` marks a stage of the program on the host clock.
A span opened while no span is open on its thread is a root: it starts a
frame and takes the next frame id, and every span and count inside it
belongs to that frame. When the root closes, each span name's self time in
the frame (the duration of its calls less what their child spans cover)
goes into the records, one record a name a frame, so the self times of a
frame add up to its root's duration; `mean`, `print_all` and
`dump_into_file` read them.

Spans record while `Timer.enable()` is on, or while a torch profiler runs:
then each span also enters `torch.profiler.record_function(name)`, so that
it lies on the profiler's clock beside the device operations it queued.
Off (the default), a span costs one flag check and `_profiler_enabled()` and
returns a shared no-op context: it records nothing, holds nothing and never
reads the device. `evaluate` always records its own span.

Counts. `Timer.count(name, n)` adds to the frame open on the thread;
`Timer.count_lazy(name, t)` keeps the tensor `t` unread and adds its sum the
first time something reads the frames (`frames`), after one synchronize:
no read on the hot path. Outside a frame both do nothing.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, NamedTuple

import torch
from torch.autograd import _profiler_enabled


class Span(NamedTuple):
    name: str
    start_ns: int     # time.perf_counter_ns()
    end_ns: int
    parent: int       # index of the enclosing span in the frame's spans; -1 for the root


class SpanFrame(NamedTuple):
    """One root span's frame: its spans in the order they opened (the root
    first), each name's self time and the counts."""

    id: int
    spans: List[Span]
    self_ms: Dict[str, float]
    counts: Dict[str, float]

    @property
    def root(self) -> str:
        return self.spans[0].name

    @property
    def ms(self) -> float:
        """The root span's duration."""
        return (self.spans[0].end_ns - self.spans[0].start_ns) * 1e-6


class _Frame:
    __slots__ = ("id", "spans", "self_ns", "counts", "lazy")

    def __init__(self, id_: int):
        self.id, self.spans, self.self_ns, self.counts, self.lazy = id_, [], {}, {}, []


class _Local(threading.local):
    def __init__(self):
        self.stack = []         # [(frame, span index)] of the thread's open spans, innermost last


class _Off:
    """The shared no-op span."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, typ, value, tb):
        return None


_local = _Local()
_OFF = _Off()


class _Open:
    """A recording span (see the module's docstring)."""

    __slots__ = ("name", "rf", "frame", "index")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _local.stack
        frame, parent = stack[-1] if stack else (_Frame(next(Timer._ids)), -1)
        self.rf = None
        if _profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.frame, self.index = frame, len(frame.spans)
        frame.spans.append([self.name, time.perf_counter_ns(), 0, parent])
        stack.append((frame, self.index))
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        stack = _local.stack
        stack.pop()
        frame = self.frame
        rec = frame.spans[self.index]
        rec[2] = end
        dur, selfs = end - rec[1], frame.self_ns
        selfs[rec[0]] = selfs.get(rec[0], 0) + dur
        if rec[3] >= 0:
            parent = frame.spans[rec[3]][0]
            selfs[parent] = selfs.get(parent, 0) - dur
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if not stack:
            Timer._close(frame)
        return False


class Timer:
    """Static registry of named timing records (milliseconds), spans and counts."""

    _records: Dict[str, List[float]] = defaultdict(list)
    _frames: List[_Frame] = []
    _ids = itertools.count()
    _on = False
    _lock = threading.Lock()

    @classmethod
    def enable(cls, on: bool = True):
        """Record spans whether or not a profiler runs (the mapping app's
        `--time_log_file`); `enable(False)` leaves it to the profiler."""
        cls._on = on

    @classmethod
    def span(cls, name: str):
        if cls._on or _profiler_enabled():
            return _Open(name)
        return _OFF

    @classmethod
    def count(cls, name: str, n=1):
        stack = _local.stack
        if stack:
            counts = stack[-1][0].counts
            counts[name] = counts.get(name, 0) + n

    @classmethod
    def count_lazy(cls, name: str, t: torch.Tensor):
        stack = _local.stack
        if stack:
            stack[-1][0].lazy.append((name, t))

    @classmethod
    def _close(cls, frame: _Frame):
        with cls._lock:
            for name, ns in frame.self_ns.items():
                cls._records[name].append(ns * 1e-6)
            cls._frames.append(frame)

    @classmethod
    def frames(cls) -> List[SpanFrame]:
        """The closed frames, oldest first, their lazy counts resolved."""
        with cls._lock:
            pending = [f for f in cls._frames if f.lazy]
            if any(t.is_cuda for f in pending for _, t in f.lazy):
                torch.cuda.synchronize()
            for f in pending:
                for name, t in f.lazy:
                    f.counts[name] = f.counts.get(name, 0) + t.sum().item()
                f.lazy = []
            return [SpanFrame(f.id, [Span(*s) for s in f.spans], {n: ns * 1e-6 for n, ns in f.self_ns.items()},
                              dict(f.counts)) for f in cls._frames]

    @classmethod
    def evaluate(cls, fn: Callable[[], Any], name: str):
        """fn() inside a span that records whether or not spans are on."""
        with _Open(name):
            return fn()

    @classmethod
    def record(cls, name: str, ms: float):
        cls._records[name].append(ms)

    @classmethod
    def mean(cls, name: str) -> float:
        r = cls._records.get(name, [])
        return sum(r) / len(r) if r else 0.0

    @classmethod
    def print_all(cls):
        print(f"{'stage':<40s} {'calls':>8s} {'mean ms':>10s} {'total ms':>10s}")
        for name, r in sorted(cls._records.items()):
            print(f"{name:<40s} {len(r):>8d} {sum(r) / len(r):>10.3f} {sum(r):>10.1f}")

    @classmethod
    def dump_into_file(cls, path: str):
        """CSV: one column per stage (utils.h DumpIntoFile layout). A span's
        column has one row a frame, 0.0 where it did not run, so a row sums
        to the frame's root span; a name only `record`ed lists its records."""
        frames = cls.frames()
        cols = {n: [f.self_ms.get(n, 0.0) for f in frames] for n in {n for f in frames for n in f.self_ms}}
        for n, r in cls._records.items():
            cols.setdefault(n, r)
        names = sorted(cols)
        rows = max((len(cols[n]) for n in names), default=0)
        with open(path, "w") as f:
            f.write(",".join(names) + "\n")
            for i in range(rows):
                f.write(",".join(f"{cols[n][i]:.4f}" if i < len(cols[n]) else "" for n in names) + "\n")

    @classmethod
    def reset(cls):
        with cls._lock:
            cls._records.clear()
            cls._frames.clear()
            cls._ids = itertools.count()
