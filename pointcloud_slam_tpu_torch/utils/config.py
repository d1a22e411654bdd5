"""YAML-subset loader for the per-lidar parameter files (pure-Python copy of
`pointcloud_slam_tpu/utils/config.py::load_yaml`: scalars, nested maps by
indentation, inline lists)."""

from __future__ import annotations

import re
from typing import Any, Dict


def _parse_scalar(v: str) -> Any:
    v = v.strip()
    if v in ("true", "True"):
        return True
    if v in ("false", "False"):
        return False
    if v.startswith("[") and v.endswith("]"):
        inner = v[1:-1].strip()
        return [] if not inner else [_parse_scalar(x) for x in inner.split(",")]
    if re.fullmatch(r"[-+]?\d+", v):
        return int(v)
    try:
        return float(v)
    except ValueError:
        return v.strip("'\"")


def load_yaml(path: str) -> Dict[str, Any]:
    """Parse a YAML subset: nested maps by indentation, scalars, inline lists."""
    root: Dict[str, Any] = {}
    stack = [(-1, root)]
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].rstrip()
            if not line.strip():
                continue
            indent = len(line) - len(line.lstrip())
            key, _, val = line.strip().partition(":")
            while stack and indent <= stack[-1][0]:
                stack.pop()
            parent = stack[-1][1]
            if val.strip() == "":
                child: Dict[str, Any] = {}
                parent[key] = child
                stack.append((indent, child))
            else:
                parent[key] = _parse_scalar(val)
    return root
