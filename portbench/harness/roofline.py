"""The yardstick for kernel rooflines: the card's published peaks and the
least work each hand-written kernel's call needs.

Peaks: one NVIDIA H100 SXM at its full 700 W power limit (NVIDIA's data
sheet, dense rates): 3.35 TB/s of HBM3, 67 TFLOP/s float32 and 33.5 TFLOP/s
float64 outside the tensor cores. A run records the card's `power.limit`
beside the share, since a card capped below 700 W cannot reach them.

K6, the small symmetric eigendecomposition (`csrc/small_eigh.cu`): the
bound counts what any method must move and a fixed operation count per
matrix, independent of how the kernel iterates (it replaces
`chip_smoke.py::k6_bound_ms` at commit 9c22c1c, which counted the sweeps
of the port's own Jacobi mirror, so that a kernel built on another method
would have been held to another amount of work):
- bytes: A read once (n * n values), w written once (n), and V written
  once (n * n) where the eigenvectors are asked for;
- operations: the symmetric QR algorithm's count (Golub and Van Loan,
  Matrix Computations, 4th ed., section 8.3): 4 n^3 / 3 for the
  eigenvalues alone, 9 n^3 with the eigenvectors.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FLOPS = {4: 67e12, 8: 33.5e12}      # by bytes a value: float32, float64


def k6_bound_s(batch: int, n: int, size: int, vectors: bool):
    """(seconds, "bytes" or "operations"): the least time one K6 launch on
    `batch` matrices of n x n, `size` bytes a value, could take."""
    by = size * batch * (n * n + n + (n * n if vectors else 0))
    ops = batch * (9.0 if vectors else 4.0 / 3.0) * n ** 3
    t_bytes, t_ops = by / HBM_BYTES_PER_S, ops / FLOPS[size]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
