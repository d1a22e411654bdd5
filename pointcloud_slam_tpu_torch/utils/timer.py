"""Per-stage timing registry (port of `pointcloud_slam_tpu/utils/timer.py`).

Behavioral parity target: reference `src/jueying_lio/include/utils.h:18-110`
(`Timer::Evaluate(lambda, name)`, `PrintAll`, `DumpIntoFile` CSV,
`GetMeanTime`) — the per-stage profile `apps/plot_timings.py` reads.

Work on the card is asynchronous. Where the JAX package blocks on each
result, `evaluate` here records a pair of CUDA events around the call on the
current stream and adds no wait: the pairs are resolved, after one
`torch.cuda.synchronize()`, the first time `mean`, `print_all` or
`dump_into_file` reads the records. An event pair measures the stream's
time from the first to the last work `fn` queued, including any gap in
which the card waited for the host. Without CUDA (or with `block=False`,
dispatch time only) the host clock is used.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Union

import torch

_Record = Union[float, tuple]   # milliseconds, or an unresolved (start, end) CUDA event pair


class Timer:
    """Static registry of named timing records (milliseconds)."""

    _records: Dict[str, List[_Record]] = defaultdict(list)

    @classmethod
    def evaluate(cls, fn: Callable[[], Any], name: str, block: bool = True):
        if block and torch.cuda.is_available() and torch.cuda.is_initialized():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            cls._records[name].append((start, end))
            return out
        t0 = time.perf_counter()
        out = fn()
        cls._records[name].append((time.perf_counter() - t0) * 1e3)
        return out

    @classmethod
    def record(cls, name: str, ms: float):
        cls._records[name].append(ms)

    @classmethod
    def _resolved(cls) -> Dict[str, List[float]]:
        """The records in milliseconds; event pairs are read after one synchronize."""
        if any(isinstance(r, tuple) for rs in cls._records.values() for r in rs):
            torch.cuda.synchronize()
            for rs in cls._records.values():
                rs[:] = [r[0].elapsed_time(r[1]) if isinstance(r, tuple) else r for r in rs]
        return cls._records

    @classmethod
    def mean(cls, name: str) -> float:
        r = cls._resolved().get(name, [])
        return sum(r) / len(r) if r else 0.0

    @classmethod
    def print_all(cls):
        print(f"{'stage':<40s} {'calls':>8s} {'mean ms':>10s} {'total ms':>10s}")
        for name, r in sorted(cls._resolved().items()):
            print(f"{name:<40s} {len(r):>8d} {sum(r) / len(r):>10.3f} {sum(r):>10.1f}")

    @classmethod
    def dump_into_file(cls, path: str):
        """CSV: one column per stage (utils.h DumpIntoFile layout)."""
        records = cls._resolved()
        names = sorted(records.keys())
        rows = max((len(records[n]) for n in names), default=0)
        with open(path, "w") as f:
            f.write(",".join(names) + "\n")
            for i in range(rows):
                f.write(",".join(
                    f"{records[n][i]:.4f}" if i < len(records[n]) else "" for n in names
                ) + "\n")

    @classmethod
    def reset(cls):
        cls._records.clear()
