"""Batched eigendecomposition of small symmetric matrices — kernel K6.

Not a port of a TPU kernel: it replaces `torch.linalg.eigh` / `eigvalsh` on
the port's 6 x 6 normal equations (the degeneracy projector of
`register/solver.py`, scan-to-map's final eigenvalues, NDT's largest
eigenvalue), where the JAX package calls `jnp.linalg.eigh` / `eigvalsh` and
stays on the device. On CUDA tensors PyTorch's eigh checks its `info` on the
host, a device -> host read every call; the kernel reads nothing back.

On CUDA tensors `eigh` and `eigvalsh` launch the hand-written kernel
`csrc/small_eigh.cu` (one thread a matrix, parallel-ordered Jacobi with
algebraic rotations, one launch a call; built with the other kernels by
`_cuda.library()`); a build or launch failure raises, and there is no
fallback. On CPU tensors they run the plain version, `eigh_plain` =
`torch.linalg.eigh`. Both read the lower triangle only.
`eigh_jacobi_mirror` repeats the kernel's sweeps in plain PyTorch, for the
CPU tests (as `bf_knn.knn_plain_split` mirrors K1's split), and
`jacobi_schedule` is the one place the sweep's order is written in Python.

Compare the kernel with the plain version by eigenvalues and by spectral
projectors V diag(w > t) V^T, never by raw V: eigenvector signs, and the
basis of a repeated eigenvalue, are arbitrary in both.
"""

from __future__ import annotations

import torch

from . import _cuda

MAX_N = 8          # kMaxN of csrc/small_eigh.cu: the largest n the kernel is instantiated for
MAX_SWEEPS = 16    # kMaxSweeps of csrc/small_eigh.cu
# TauBig<T>::value of csrc/small_eigh.cu: above it tau^2 could overflow, and t = 1 / (2 tau)
TAU_BIG = {torch.float32: 2.0 ** 60, torch.float64: 2.0 ** 500}


def jacobi_schedule(n: int) -> list[list[tuple[int, int]]]:
    """The kernel's order of rotations in a sweep (its `kSchedule`): a list of
    steps, each a list of disjoint pairs (p, q) in the order and orientation
    the kernel rotates them. Every pair of 0..n-1 comes once a sweep. Round
    robin by the circle method, as the kernel runs it: with m = n rounded up
    to even and L = m - 1, the kernel rotates the fixed pairs (k, m - 1 - k)
    of a relabeled matrix and turns the labels 0..L-1 by one after each
    step, so step s pairs pi(k), pi(m - 1 - k) with pi(i) = (i + s) mod L
    (and pi(L) = L). Even n gives n - 1 steps of n / 2 pairs; odd n gives n
    steps, the pair of each step that holds the padding label n (a bye) left
    out."""
    m = n + n % 2
    L = m - 1
    steps = []
    for s in range(L):
        def pi(i):
            return i if i == L else (i + s) % L
        steps.append([(pi(k), pi(m - 1 - k)) for k in range(m // 2) if m - 1 - k < n])
    return steps


def eigh_plain(A: torch.Tensor):
    """The plain version: `torch.linalg.eigh` (lower triangle, w ascending,
    eigenvectors as the columns of V)."""
    return torch.linalg.eigh(A)


def _check(A: torch.Tensor):
    if A.dim() < 2 or A.shape[-1] != A.shape[-2] or not 1 <= A.shape[-1] <= MAX_N:
        raise ValueError(f"the kernel takes (..., n, n) with 1 <= n <= {MAX_N}, got {tuple(A.shape)}")
    if A.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernel takes float32 or float64, got {A.dtype}")
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")


def _launch(A: torch.Tensor, vectors: bool):
    """One launch of K6 on the current stream: (w (..., n), V (..., n, n) or None)."""
    _check(A)
    n = A.shape[-1]
    batch_shape = A.shape[:-2]
    flat = A.reshape(-1, n, n).contiguous()
    B = flat.shape[0]
    if B >= 2 ** 31:
        raise ValueError("batch too large for the kernel's 32-bit indexing")
    w = torch.empty((B, n), dtype=A.dtype, device=A.device)
    V = torch.empty((B, n, n), dtype=A.dtype, device=A.device) if vectors else None
    if B:
        with torch.cuda.device(A.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _cuda.library().pcs_small_eigh(flat.data_ptr(), B, n, w.data_ptr(),
                                                 V.data_ptr() if vectors else None, int(vectors),
                                                 int(A.dtype == torch.float64), stream)
        if err != 0:
            raise RuntimeError(f"small_eigh kernel launch failed (batch={B}, n={n}, {A.dtype}): cudaError {err}")
    return w.reshape(*batch_shape, n), (V.reshape(*batch_shape, n, n) if vectors else None)


def eigh(A: torch.Tensor):
    """Eigendecomposition of symmetric (..., n, n), n <= MAX_N: (w (..., n)
    ascending, V (..., n, n) with the eigenvectors as columns), from the
    lower triangle. CUDA tensors: one launch of K6, no host read; CPU
    tensors: `eigh_plain`. Counts its CUDA launches in `eigh.launches`."""
    if A.device.type == "cpu":
        return eigh_plain(A)
    w, V = _launch(A, vectors=True)
    eigh.launches += 1
    return w, V


eigh.launches = 0


def eigvalsh(A: torch.Tensor) -> torch.Tensor:
    """Ascending eigenvalues of symmetric (..., n, n), n <= MAX_N, from the
    lower triangle. CUDA tensors: one launch of K6 (without the
    eigenvectors), no host read; CPU tensors: `torch.linalg.eigvalsh`.
    Counts its CUDA launches in `eigvalsh.launches`."""
    if A.device.type == "cpu":
        return torch.linalg.eigvalsh(A)
    w, _ = _launch(A, vectors=False)
    eigvalsh.launches += 1
    return w


eigvalsh.launches = 0


def eigh_jacobi_mirror(A: torch.Tensor, max_sweeps: int = MAX_SWEEPS, eps: float | None = None):
    """The kernel's algorithm in plain PyTorch, for the CPU tests: Jacobi
    sweeps on the lower triangle of each (..., n, n) matrix in the order of
    `jacobi_schedule(n)`, each rotation Rutishauser's (Golub & Van Loan,
    sym.schur2): tau = (a_qq - a_pp) / (2 a_pq), t = sign(tau) / (|tau| +
    sqrt(1 + tau^2)) (1 / (2 tau) above `TAU_BIG`), c = 1 / sqrt(1 + t^2),
    s = t c, a_pp -= t a_pq, a_qq += t a_pq, a_pq = 0. Where a_pq is exactly
    0, t = 0 (the rotation is the identity). The kernel takes t, c and s
    from refined approximations where they hold and by IEEE arithmetic, as
    here, elsewhere: the two differ by rounding. A matrix stops when every
    off-diagonal |a_pq| is at most `eps` (default the dtype's machine
    epsilon) times its largest |a_ii|, or after `max_sweeps`; a NaN never
    stops it. Then a stable ascending sort of the diagonal carries V's
    columns. Returns (w, V, sweeps run per matrix)."""
    n = A.shape[-1]
    batch_shape = A.shape[:-2]
    low = torch.tril(A.reshape(-1, n, n))
    a = low + torch.tril(low, -1).mT
    B = a.shape[0]
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(B, n, n).clone()
    eps = torch.finfo(A.dtype).eps if eps is None else eps
    big = TAU_BIG[A.dtype]
    iu = torch.triu_indices(n, n, 1, device=A.device)
    sweeps = torch.zeros(B, dtype=torch.int64, device=A.device)
    schedule = jacobi_schedule(n)
    for _ in range(max_sweeps):
        off = a[:, iu[0], iu[1]].abs().amax(dim=1) if n > 1 else a.new_zeros(B)
        diag = torch.diagonal(a, dim1=1, dim2=2).abs().amax(dim=1)
        active = ~(off <= eps * diag)
        if not bool(active.any()):
            break
        sweeps += active.to(torch.int64)
        on = active[:, None]
        for step in schedule:
            for p, q in step:
                apq, app, aqq = a[:, p, q], a[:, p, p], a[:, q, q]
                tau = (aqq - app) / (2.0 * apq)
                at = tau.abs()
                t = torch.copysign(1.0 / torch.where(at > big, 2.0 * at, at + torch.sqrt(1.0 + tau * tau)), tau)
                t = torch.where(apq == 0, 0.0, t)
                c = 1.0 / torch.sqrt(1.0 + t * t)
                s = t * c
                c, s = c[:, None], s[:, None]
                others = [r for r in range(n) if r not in (p, q)]
                if others:
                    arp, arq = a[:, others, p], a[:, others, q]
                    a[:, others, p] = a[:, p, others] = torch.where(on, c * arp - s * arq, arp)
                    a[:, others, q] = a[:, q, others] = torch.where(on, s * arp + c * arq, arq)
                a[:, p, p] = torch.where(active, app - t * apq, app)
                a[:, q, q] = torch.where(active, aqq + t * apq, aqq)
                a[:, p, q] = a[:, q, p] = torch.where(active, 0.0, apq)
                vp, vq = V[:, :, p], V[:, :, q]
                V[:, :, p], V[:, :, q] = torch.where(on, c * vp - s * vq, vp), torch.where(on, s * vp + c * vq, vq)
    d = torch.diagonal(a, dim1=1, dim2=2)
    order = torch.argsort(d, dim=1, stable=True)
    w = torch.gather(d, 1, order)
    V = torch.gather(V, 2, order[:, None, :].expand(B, n, n))
    return w.reshape(*batch_shape, n), V.reshape(*batch_shape, n, n), sweeps.reshape(batch_shape)
