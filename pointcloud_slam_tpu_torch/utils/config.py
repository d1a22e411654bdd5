"""YAML-subset loader and writer for the per-lidar parameter files
(pure-Python copy of `pointcloud_slam_tpu/utils/config.py`: scalars, nested
maps by indentation, inline lists; files written here round-trip).

`load_with_overlay` is the deployment registry's overlay (the reference's
`scripts/register_conf.sh` copies the chosen YAML to a system path, which
packages load with a local-file fallback): the local file, overlaid key by
key by the system copy where it exists.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional


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


def load_with_overlay(local_path: str, system_path: Optional[str] = None) -> Dict[str, Any]:
    """Local config overlaid by the system registry copy if present
    (changelog V1.1.6 behavior)."""
    cfg = load_yaml(local_path) if os.path.exists(local_path) else {}
    if system_path and os.path.exists(system_path):
        overlay = load_yaml(system_path)
        _deep_update(cfg, overlay)
    return cfg


def _deep_update(dst: Dict, src: Dict):
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v


def save_yaml(path: str, cfg: Dict[str, Any], indent: int = 0):
    with open(path, "w") as f:
        _write_yaml(f, cfg, 0)


def _write_yaml(f, cfg: Dict[str, Any], indent: int):
    for k, v in cfg.items():
        pad = "  " * indent
        if isinstance(v, dict):
            f.write(f"{pad}{k}:\n")
            _write_yaml(f, v, indent + 1)
        elif isinstance(v, list):
            f.write(f"{pad}{k}: [{', '.join(str(x) for x in v)}]\n")
        else:
            f.write(f"{pad}{k}: {v}\n")
