"""Builds the hand-written CUDA kernels of `csrc/` and binds them with ctypes.

The sources are compiled with nvcc for sm_90a into a shared library with a
plain C interface, at first use, under `build/torch_kernels/` at the root of
the checkout (git-ignored). The library name carries a hash of the sources,
so an edited kernel is rebuilt and a stale one is never loaded. Nothing here
runs at import time: the CPU test suite imports every module of the package
on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on any failure.
    The library carries `build_seconds` (time in nvcc, 0.0 when it was built
    before) and `build_log` (nvcc's -Xptxas -v report)."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources) + " ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"libpcs_torch_kernels_{digest.hexdigest()[:12]}.so"
    seconds, log = 0.0, ""
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds, log = time.perf_counter() - t0, proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
        os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees half a file
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    # (queries, n, database, m, k, instance, splits, d2, idx, part_d2, part_idx, stream)
    lib.pcs_bf_knn.argtypes = [p, i, p, i, i, i, i, p, p, p, p, p]
    lib.pcs_bf_knn.restype = i
    # (queries, n, database, m, splits, d2, idx, part_d2, part_idx, stream)
    lib.pcs_bf_nn.argtypes = [p, i, p, i, i, p, p, p, p, p]
    lib.pcs_bf_nn.restype = i
    lib.build_seconds, lib.build_log = seconds, log
    return lib
