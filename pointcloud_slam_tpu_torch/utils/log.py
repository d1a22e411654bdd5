"""Leveled logging + debug data channels — the observability layer (the
PyTorch port's copy of `pointcloud_slam_tpu/utils/log.py`).

Behavioral parity targets:
  - glog `LOG(INFO/WARNING/ERROR)` used throughout jueying_lio
    (e.g. src/jueying_lio/src/laser_mapping.cc) and ROS_INFO/ROS_WARN in
    jueying_slam -> a stdlib-logging-based leveled logger with the glog-style
    single-letter severity prefix.
  - debug topics (effect-points cloud `laser_mapping.cc:362-385`,
    loop-constraint MarkerArray `mapOptmization.cpp:1020-1068`, IMU debug file
    `imu_processing.hpp:311`) -> `DebugChannels`: named per-frame array dumps
    written as npz (clouds/markers) for offline inspection, enabled per
    channel so the hot loop pays nothing when a channel is off.

Host-side only; nothing here runs on device. `publish` reads tensors back
(one read each), so callers guard device values on `enabled()`.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

_FMT = "%(levelname).1s%(asctime)s.%(msecs)03d %(name)s] %(message)s"
_DATEFMT = "%m%d %H:%M:%S"

class _StderrHandler(logging.StreamHandler):
    """A handler that writes to the `sys.stderr` of the moment: one that kept
    the stream it was made with writes into a closed one once the process
    replaces stderr (as a test's output capture does)."""

    @property
    def stream(self):
        return sys.stderr

    @stream.setter
    def stream(self, value):
        pass


def get_logger(name: str = "pcs", level: int = logging.INFO) -> logging.Logger:
    """glog-look-alike logger: `I0816 12:34:56.789 pcs] message`.

    Each logger carries its own handler and does not propagate: the JAX
    package configures the stdlib logger "pcs" of the same names, and in a
    process that imports both, a message would otherwise reach both handlers."""
    lg = logging.getLogger(name if name.startswith("pcs") else f"pcs.{name}")
    if not any(isinstance(h, _StderrHandler) for h in lg.handlers):
        h = _StderrHandler()
        h.setFormatter(logging.Formatter(_FMT, datefmt=_DATEFMT))
        lg.addHandler(h)
        lg.propagate = False
    lg.setLevel(level)
    return lg


class DebugChannels:
    """Named debug-data channels with per-channel enablement.

    The role of the reference's debug publishers: a disabled channel is a
    no-op (callers should guard expensive device->host pulls on `enabled()`),
    an enabled one buffers (frame, arrays) records and flushes them to
    `<dir>/<channel>_%06d.npz`. Typical channels mirror the reference topics:
    "effect_points" (matched-point cloud), "loop_constraints" (i, j index
    pairs + endpoints), "imu_debug" (per-sample state rows).
    """

    def __init__(self, out_dir: str = "debug", enabled: Optional[List[str]] = None,
                 flush_every: int = 1):
        self.out_dir = out_dir
        self._enabled = set(enabled or [])
        self.flush_every = flush_every
        self._buf: Dict[str, List] = {}
        self._count: Dict[str, int] = {}

    def enable(self, channel: str):
        self._enabled.add(channel)

    def enabled(self, channel: str) -> bool:
        return channel in self._enabled

    def publish(self, channel: str, frame: int, **arrays):
        """Record named arrays for `channel` at `frame`; no-op when disabled."""
        if channel not in self._enabled:
            return
        rec = {k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v) for k, v in arrays.items()}
        rec["_frame"] = np.asarray(frame)
        rec["_stamp"] = np.asarray(time.time())
        self._buf.setdefault(channel, []).append(rec)
        if len(self._buf[channel]) >= self.flush_every:
            self.flush(channel)

    def flush(self, channel: Optional[str] = None):
        names = [channel] if channel else list(self._buf)
        for name in names:
            records = self._buf.pop(name, [])
            if not records:
                continue
            os.makedirs(self.out_dir, exist_ok=True)
            for rec in records:
                k = self._count.get(name, 0)
                self._count[name] = k + 1
                np.savez(os.path.join(self.out_dir, f"{name}_{k:06d}.npz"), **rec)

    def close(self):
        self.flush()
