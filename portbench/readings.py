"""Reads a cell's correctness numbers over many seeds in one process: the
readings its limits are set from (the program on a dozen seeds or more, the
precision control on three or more).

    python portbench/readings.py --workload <cell> --impl program --seeds 1,2,3 --seconds 4
    python portbench/readings.py --workload <cell> --impl control --seeds 1,2,3 --seconds 4

Each seed is a whole run of the cell (set-up, a window of `--seconds` at the
cell's own load, the comparison with the reference); one JSON line a seed
with every number compared, and `--out` appends the lines to a file. The
benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--impl", default="program",
                   help="program | control | (LIO) control_f32_update, the update's algebra in float32")
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    import torch

    from portbench.harness import core

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    cell = core.resolve(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = core.run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0), t, impl=args.impl)
        row = {"workload": args.workload, "impl": args.impl, "seed": seed, "correct": out["correct"],
               "readings": {n: v for n, v, _ in out["checks"]},
               "metrics": {k: m["value"] for k, m in out["metrics"].items()}, "info": out["info"],
               "failed": out["failed"], "attempted": out["attempted"]}
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
