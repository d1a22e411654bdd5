"""Runs one benchmark cell once on the card and prints its result line.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's files are found by name (`portbench/workloads/<cell>.json` and
what it names); see `portbench/README.md`. The last line of standard output
is one JSON object (`correct`, `attempted`, `failed`, `metrics`, `device`,
with `--trace 1` also `breakdown`, and last `checks`: every number compared
with the reference beside its limit); the checks are also the last lines of
standard error. A run without a card, or with fewer cards than the cell
asks for, or that finds JAX or the JAX package loaded, prints no result and
exits non-zero.
"""

import time

T_PROCESS = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache of the program at a fixed path inside the checkout
CACHE = ROOT / "build" / "portbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
sys.path.insert(0, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="the cell's name (portbench/workloads/<name>.json)")
    p.add_argument("--seed", type=int, required=True, help="seeds the inputs; any whole number")
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: report the per-layer metrics from a traced run instead of the end-to-end ones")
    return p.parse_args(argv)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    args = parse(argv)
    import pointcloud_slam_tpu_torch  # noqa: F401  (the system under test: without it there is nothing to run)

    from portbench.harness import core

    cell = core.resolve(args.workload)
    import torch

    chips = cell.spec["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA card(s), this machine has {n}; no result", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.init()
    torch.set_num_threads(1)      # one process, few threads: the frames' work is on the card
    out = core.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_PROCESS)
    found = core.forbidden_modules(list(sys.modules))
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: {found}; no result", file=sys.stderr)
        return 3
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                   "memory_peak_bytes": out["memory_peak_bytes"], "power_limit": power_limit()}
    if args.trace:
        device_info.update(busy_s=out["busy_s"], window_s=out["window_s"])
    result = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
              "metrics": out["metrics"], "device": device_info}
    if args.trace:
        result["breakdown"] = out["breakdown"]
    result["info"] = out["info"]
    result["checks"] = {name: [value, limit] for name, value, limit in out["checks"]}
    for name, value, limit in out["checks"]:
        print(f"check {name} {value!r} limit {limit!r} {'ok' if value <= limit else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
