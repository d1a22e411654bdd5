"""Builds the hand-written CUDA kernels of `csrc/` and binds them with ctypes.

The sources are compiled with nvcc for sm_90a, one nvcc process a source,
all started together, and linked into one shared library with a plain C
interface, at first use, under `build/torch_kernels/` at the root of the
checkout (git-ignored). The library name carries a hash of the sources and
flags, so an edited kernel is rebuilt and a stale one is never loaded.
Nothing here runs at import time: the CPU test suite imports every module of
the package on machines without nvcc.
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]   # compile flags; the link adds -shared


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
    The library carries `build_seconds` (wall time of the compiles and the
    link, 0.0 when it was built before) and `build_log` (nvcc's -Xptxas -v
    report of every source)."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources) + " ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"libpcs_torch_kernels_{digest.hexdigest()[:12]}.so"
    seconds, log = 0.0, ""
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
            objs = [os.path.join(tmp_dir, src.stem + ".o") for src in sources]
            cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)] for src, obj in zip(sources, objs)]
            procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                     for cmd in cmds]
            outs = [p.communicate()[0] for p in procs]
            log = "".join(outs)
            for cmd, proc, out in zip(cmds, procs, outs):
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
            tmp = os.path.join(tmp_dir, "lib.so")
            link = [nvcc, "-shared", "-o", tmp, *objs]
            proc = subprocess.run(link, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees half a file
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    # (queries, n, database, m, k, instance, splits, d2, idx, part_d2, part_idx, floor_d2, floor_idx, stream)
    lib.pcs_bf_knn.argtypes = [p, i, p, i, i, i, i, p, p, p, p, p, p, p]
    lib.pcs_bf_knn.restype = i
    # (queries, n, database, m, splits, d2, idx, part_d2, part_idx, stream)
    lib.pcs_bf_nn.argtypes = [p, i, p, i, i, p, p, p, p, p]
    lib.pcs_bf_nn.restype = i
    # (A, batch, n, w, V, want_vectors, is_double, stream)
    lib.pcs_small_eigh.argtypes = [p, i, i, p, p, i, i, p]
    lib.pcs_small_eigh.restype = i
    lib.build_seconds, lib.build_log = seconds, log
    return lib
