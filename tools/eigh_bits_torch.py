#!/usr/bin/env python3
"""Kernel K6 (`ops.small_eigh`, the small eigh) of one checkout on one NVIDIA
GPU: its device time apart from the wrapper's host time, at the call sites'
shapes — 6 x 6 at batch 1 in float32 and float64, at batch 24 and at batch
1,000 — on seeded matrices in the callers' form (Gram matrices J J^T of
6 x 200 Jacobians at scales 1e-3 to 1e6, every fifth with a direction
unobserved, turned by random rotations). For each shape:

  device_ms        the device's time a launch: 100 calls captured in one
                   CUDA graph, replayed 10 times between CUDA events (every
                   launch timed, the graph's gap between kernels included)
  host_ms          the wrapper's host time a call: 1,000 calls with no
                   synchronise on a host clock, then one synchronise
  ms, ms_back_to_back
                   CUDA events around one call at a time (median of 20) and
                   around 100 calls queued back to back
  eigvalsh_ms, eigvalsh_device_ms, library_ms, library_eigvalsh_ms
                   the same checkout's eigvalsh (one call at a time, and its
                   device time), and torch.linalg.eigh / eigvalsh (one call
                   at a time; each reads its info back)
  sweeps           the sweeps each matrix needs, from the checkout's own
                   `eigh_jacobi_mirror` (min, max, mean)

and `floor`: device_ms and host_ms of the same path at n = 1 (one 1 x 1
matrix: the kernel rotates nothing), in float32 and float64. `registers`
holds what `nvcc -Xptxas -v` reports for `small_eigh_kernel<T, N, V>` at
N = 6 and 8, float32 and float64, with and without eigenvectors: registers,
stack frame, spill stores and loads.

    python3 tools/eigh_bits_torch.py --root build/parent --save build/parent_eigh.pt
    python3 tools/eigh_bits_torch.py --root . --save build/change_eigh.pt
    python3 tools/eigh_bits_torch.py --compare build/parent_eigh.pt build/change_eigh.pt
    python3 tools/eigh_bits_torch.py --root build/parent --sweeps   # on the CPU

`--root` is the checkout whose `pointcloud_slam_tpu_torch` is imported (its
kernels are built under its own `build/torch_kernels/`); the timing helpers
are this checkout's `chip_smoke.py`. Each run prints one JSON line with the
card's name and power limit. `--compare` prints, per shape, the largest
eigenvalue difference between the two files over max|lambda| and exits 1
when one exceeds 2e-5 (float32) / 2e-12 (float64), twice the gate each
checkout holds against torch.linalg.eigh. To compare two commits, unpack
the other under `build/` and run both in one call, in turns (A, B, B, A).
`--sweeps` needs no card: it prints, for each of the card tests' hard
spectra (this checkout's `io.synthetic.eigh_hard_spectra`) in float32 and
float64, the mean, least and most sweeps of the --root checkout's
`eigh_jacobi_mirror`.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

TOOL_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [("batch_1_f32", 1, "float32"), ("batch_1_f64", 1, "float64"), ("batch_24_f32", 24, "float32"),
          ("batch_1000_f32", 1000, "float32")]
TOL = {"float32": 2e-5, "float64": 2e-12}
KERNEL_NAME = re.compile(r"small_eigh_kernelI([fd])Li(\d+)ELb([01])E")


def matrices(batch, seed=6):
    """(batch, 6, 6) float64 in the callers' form, in numpy alone (the port is
    imported only from --root)."""
    g = np.random.default_rng(seed)
    J = g.normal(size=(batch, 6, 200)) * 10.0 ** g.uniform(-1.5, 3, size=(batch, 1, 1))
    J[::5, 0] = 0.0
    Q = np.linalg.qr(g.normal(size=(batch, 6, 6)))[0]
    return Q @ (J @ J.transpose(0, 2, 1)) @ Q.transpose(0, 2, 1)


def registers(_cuda):
    """nvcc -Xptxas -v on the checkout's csrc/small_eigh.cu: {"f32 N=6 vectors":
    {registers, stack, spill_stores, spill_loads}, ...} for N = 6 and 8."""
    src = _cuda.CSRC / "small_eigh.cu"
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_cuda.BUILD_DIR) as tmp:
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-c", "-o", os.path.join(tmp, "k.o"), str(src)]
        out = subprocess.run(cmd, capture_output=True, text=True, check=True)
    found, name = {}, None
    for line in (out.stdout + out.stderr).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            k = KERNEL_NAME.search(m.group(1))
            name = f"{'f32' if k.group(1) == 'f' else 'f64'} N={k.group(2)} " \
                   f"{'vectors' if k.group(3) == '1' else 'values'}" if k and k.group(2) in ("6", "8") else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            found.setdefault(name, {}).update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                              spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found.setdefault(name, {})["registers"] = int(m.group(1))
    return dict(sorted(found.items()))


def run(root, save):
    import torch

    sys.path.insert(0, TOOL_ROOT)
    from chip_smoke import cuda_ms, cuda_ms_back_to_back, device_ms, host_ms

    sys.path.insert(0, os.path.abspath(root))
    from pointcloud_slam_tpu_torch.ops import _cuda, small_eigh

    assert small_eigh.__file__.startswith(os.path.abspath(root)), small_eigh.__file__
    if not torch.cuda.is_available():
        raise SystemExit("eigh_bits_torch: no CUDA device")
    dev = torch.device("cuda", 0)
    H = matrices(max(b for _, b, _ in SHAPES))
    floor = {}
    for dtype in ("float32", "float64"):
        one = torch.ones(1, 1, 1, dtype=getattr(torch, dtype), device=dev)
        floor[dtype] = dict(device_ms=device_ms(lambda: small_eigh.eigh(one)),
                            host_ms=host_ms(lambda: small_eigh.eigh(one)))
    out, times, sweeps = {}, {}, {}
    for name, batch, dtype in SHAPES:
        A = torch.from_numpy(H[:batch]).to(getattr(torch, dtype)).to(dev)
        w, V = small_eigh.eigh(A)
        torch.cuda.synchronize()
        out[name] = (A.cpu(), w.cpu(), V.cpu())
        times[name] = dict(ms=cuda_ms(lambda: small_eigh.eigh(A), reps=20),
                           ms_back_to_back=cuda_ms_back_to_back(lambda: small_eigh.eigh(A)),
                           device_ms=device_ms(lambda: small_eigh.eigh(A)),
                           host_ms=host_ms(lambda: small_eigh.eigh(A)),
                           eigvalsh_ms=cuda_ms(lambda: small_eigh.eigvalsh(A), reps=20),
                           eigvalsh_device_ms=device_ms(lambda: small_eigh.eigvalsh(A)),
                           library_ms=cuda_ms(lambda: torch.linalg.eigh(A), reps=20),
                           library_eigvalsh_ms=cuda_ms(lambda: torch.linalg.eigvalsh(A), reps=20))
        s = small_eigh.eigh_jacobi_mirror(A.cpu())[2].to(torch.float64)
        sweeps[name] = dict(min=int(s.min()), max=int(s.max()), mean=float(s.mean()))
    if save:
        torch.save(out, save)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"root": root, "nvidia_smi": smi, "floor": floor, "times": times, "sweeps": sweeps,
                      "registers": registers(_cuda)}), flush=True)


def sweeps_of_hard_cases(root):
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location(
        "_synthetic", os.path.join(TOOL_ROOT, "pointcloud_slam_tpu_torch", "io", "synthetic.py"))
    synthetic = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synthetic)   # numpy only at import: the --root port stays the one imported
    sys.path.insert(0, os.path.abspath(root))
    from pointcloud_slam_tpu_torch.ops import small_eigh

    assert small_eigh.__file__.startswith(os.path.abspath(root)), small_eigh.__file__
    out = {}
    for case, A in synthetic.eigh_hard_spectra().items():
        for dtype in (torch.float32, torch.float64):
            s = small_eigh.eigh_jacobi_mirror(torch.from_numpy(A).to(dtype))[2].to(torch.float64)
            out[f"{case} {str(dtype)[6:]}"] = dict(mean=float(s.mean()), min=int(s.min()), max=int(s.max()))
    print(json.dumps({"root": root, "sweeps": out}), flush=True)


def compare(a, b):
    import torch

    A, B = torch.load(a), torch.load(b)
    diff, ok = {}, True
    for name, _, dtype in SHAPES:
        (m, wa, _), (_, wb, _) = A[name], B[name]
        assert torch.equal(m, B[name][0]), f"{name}: the two files hold other inputs"
        scale = torch.maximum(wa.abs().amax(dim=-1, keepdim=True), wb.abs().amax(dim=-1, keepdim=True))
        diff[name] = float(((wa - wb).abs() / scale).max())
        ok &= diff[name] <= TOL[dtype]
    print(json.dumps({"compare": [a, b], "eig_rel_diff": diff, "within": ok}), flush=True)
    return 0 if ok else 1


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=".", help="checkout whose port is imported")
    ap.add_argument("--save", help="file the inputs and outputs are saved to")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"), help="two saved files to hold close")
    ap.add_argument("--sweeps", action="store_true", help="the mirror's sweeps on the hard spectra (CPU)")
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    if args.sweeps:
        sweeps_of_hard_cases(args.root)
        return 0
    run(args.root, args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
