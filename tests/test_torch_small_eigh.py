"""Kernel K6 (`pointcloud_slam_tpu_torch.ops.small_eigh`) on the CPU: its
plain version against JAX's `jnp.linalg.eigh` / `eigvalsh` on the normal
equations of scan-to-map and NDT frames, the kernel's Jacobi sweeps
(`eigh_jacobi_mirror`, the kernel's stop rule) against `torch.linalg.eigh`
on hard spectra, and the degeneracy projector against JAX's. The CUDA
kernel itself runs only on the card: tests/test_torch_cuda.py and
chip_smoke.py.

Tolerances: eigenvalues within 1e-5 x max|lambda| in float32 (1e-12 in
float64); projectors V diag(w > t) V^T within 1e-4, with t placed in a wide
gap of the spectrum. Eigenvectors are compared only through projectors and
the reconstruction V diag(w) V^T: their signs, and the basis of a repeated
eigenvalue, are arbitrary.
"""

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pointcloud_slam_tpu.register import solver as jsolver
from pointcloud_slam_tpu_torch import ops as tops, register as treg
from pointcloud_slam_tpu_torch.io import synthetic as tsyn
from pointcloud_slam_tpu_torch.models.liosam import scan2map as ts2m
from pointcloud_slam_tpu_torch.ops import small_eigh
from pointcloud_slam_tpu_torch.register import solver as tsolver

torch.set_num_threads(2)

EIG_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _projector(w, V, t):
    keep = (w > t).to(V.dtype)
    return (V * keep[..., None, :]) @ V.mT


def _sym_lower(A):
    return torch.tril(A) + torch.tril(A, -1).mT


def _gap_threshold(w):
    """A threshold in the widest gap of an ascending spectrum (log scale
    where both sides are positive), so a projector is well defined."""
    w = np.asarray(w, np.float64)
    i = int(np.argmax(np.diff(w) / np.maximum(np.abs(w[1:]), 1e-30)))
    return float(np.sqrt(w[i] * w[i + 1]) if w[i] > 0 else 0.5 * (w[i] + w[i + 1]))


@pytest.fixture(scope="module")
def frame_h():
    """Normal equations (6, 6) float32 of real frames on the port's CPU path:
    scan-to-map on the feature world (the final H of two frames) and NDT P2D
    on the room pair (the final H of two aligns)."""
    Hs = []
    cfg = ts2m.Scan2MapConfig(solver=treg.SolverConfig(max_iterations=4), degeneracy_eig=1.0)
    corners_w, surfs_w = tsyn.make_feature_world(seed=3)
    maps = []
    for cloud, g in ((corners_w, cfg.corner_grid), (surfs_w, cfg.surf_grid)):
        pts = torch.from_numpy(np.ascontiguousarray(cloud.T.astype(np.float32)))
        maps.append(tops.insert(g, tops.create(g, device="cpu"), pts, torch.ones(pts.shape[1], dtype=torch.bool)))
    eye = np.eye(3, dtype=np.float32)
    for k, t in enumerate(([0.4, 0.3, 1.0], [2.0, -1.0, 1.0])):
        c, cm = tsyn.take_scan(corners_w, eye, np.asarray(t, np.float32), 256, seed=k)
        s, sm = tsyn.take_scan(surfs_w, eye, np.asarray(t, np.float32), 1024, seed=100 + k)
        args = [torch.from_numpy(np.ascontiguousarray(a.T) if a.ndim == 2 else a) for a in (c, cm, s, sm)]
        Hs.append(ts2m.scan_to_map(cfg, *maps, *args).H)
    world = tsyn.make_room_cloud(6000, seed=0)
    w = torch.from_numpy(np.ascontiguousarray(world.T))
    ncfg = treg.NDTConfig(resolution=1.0, solver=treg.SolverConfig(max_iterations=6))
    gc, g = treg.ndt.build_target(ncfg, w, capacity=1 << 13)
    for seed in (1, 2):
        R, t = tsyn.random_pose(seed=seed, rot_scale=0.03, trans_scale=0.2)
        src = torch.from_numpy(np.ascontiguousarray(((world[:2000] - t) @ R).astype(np.float32).T))
        Hs.append(treg.ndt.align(gc, g, src, cfg=ncfg).H)
    H = torch.stack(Hs)
    assert H.shape == (4, 6, 6) and H.dtype == torch.float32 and bool(torch.isfinite(H).all())
    return H


def test_plain_eigh_matches_jax_on_frame_normal_equations(frame_h):
    """The plain version (`torch.linalg.eigh` / `eigvalsh`, what the wrappers
    run on CPU tensors) against `jnp.linalg.eigh` / `eigvalsh` on the same
    float32 H: eigenvalues within 1e-5 x max|lambda|, projectors at a
    threshold in the widest gap within 1e-4."""
    w, V = small_eigh.eigh(frame_h)
    assert torch.equal(w, small_eigh.eigh_plain(frame_h)[0])
    assert torch.equal(small_eigh.eigvalsh(frame_h), torch.linalg.eigvalsh(frame_h))
    wj, Vj = jnp.linalg.eigh(jnp.asarray(frame_h.numpy()))
    wj, Vj = np.array(wj), np.array(Vj)
    scale = np.abs(wj).max(axis=1, keepdims=True)
    assert (np.abs(w.numpy() - wj) <= 1e-5 * scale).all(), np.abs(w.numpy() - wj) / scale
    wvj = np.asarray(jnp.linalg.eigvalsh(jnp.asarray(frame_h.numpy())))
    assert (np.abs(small_eigh.eigvalsh(frame_h).numpy() - wvj) <= 1e-5 * scale).all()
    for b in range(frame_h.shape[0]):
        t = _gap_threshold(wj[b])
        Pt = _projector(w[b], V[b], t).numpy()
        Pj = _projector(torch.from_numpy(wj[b]), torch.from_numpy(Vj[b]), t).numpy()
        np.testing.assert_allclose(Pt, Pj, atol=1e-4)


def test_jacobi_mirror_on_frame_normal_equations(frame_h):
    """The kernel's sweeps on the same frames' H against the plain version,
    in float32 and float64."""
    for dt in (torch.float32, torch.float64):
        H = frame_h.to(dt)
        w, V, sweeps = small_eigh.eigh_jacobi_mirror(H)
        wp, Vp = small_eigh.eigh_plain(H)
        scale = wp.abs().amax(dim=-1, keepdim=True)
        assert bool(((w - wp).abs() <= EIG_RTOL[dt] * scale).all()), (dt, float((w - wp).abs().max()))
        assert int(sweeps.max()) < small_eigh.MAX_SWEEPS
        for b in range(H.shape[0]):
            t = _gap_threshold(wp[b].numpy())
            torch.testing.assert_close(_projector(w[b], V[b], t), _projector(wp[b], Vp[b], t), rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(tsyn.eigh_hard_spectra()))
def test_jacobi_mirror_hard_cases(case, dtype):
    """Repeated eigenvalues, a rank-deficient corridor-like H, scales from
    1e-3 to 1e6, a 1e8 condition number, indefinite and zero matrices: the
    kernel's sweeps stop by the rule before MAX_SWEEPS; eigenvalues within
    1e-5 (f32) / 1e-12 (f64) x max|lambda| of torch.linalg.eigh; V orthogonal
    and V diag(w) V^T the matrix to the same relative tolerance (x 10);
    exactly diagonal input is not rotated at all."""
    A = torch.from_numpy(tsyn.eigh_hard_spectra()[case]).to(dtype)
    w, V, sweeps = small_eigh.eigh_jacobi_mirror(A)
    wp = torch.linalg.eigvalsh(A)
    scale = wp.abs().amax(dim=-1, keepdim=True).clamp(min=torch.finfo(dtype).tiny)
    tol = EIG_RTOL[dtype]
    assert bool(((w - wp).abs() <= tol * scale).all()), float(((w - wp).abs() / scale).max())
    assert bool((w[..., 1:] >= w[..., :-1]).all())
    assert int(sweeps.max()) < small_eigh.MAX_SWEEPS, int(sweeps.max())
    eye = torch.eye(6, dtype=dtype)
    assert float((V.mT @ V - eye).abs().max()) <= 10 * tol
    rec = V @ torch.diag_embed(w) @ V.mT
    assert bool(((rec - A).abs() <= 10 * tol * scale[..., None]).all())
    if case in ("identity", "diagonal_ties", "zero"):
        assert int(sweeps.max()) == 0
        assert torch.equal(w, wp) and torch.equal(V.abs().sum(dim=-2), torch.ones_like(w))


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_jacobi_mirror_any_n_and_batch_shape(n):
    """Every n the kernel is built for, with batch dimensions kept, reading
    the lower triangle only (the upper one is garbage here)."""
    g = np.random.default_rng(n)
    X = torch.from_numpy(g.normal(size=(2, 3, n, n)))
    garbage = torch.triu(torch.from_numpy(g.normal(size=(2, 3, n, n))), 1)
    A = torch.tril(X + X.mT) + garbage
    w, V, sweeps = small_eigh.eigh_jacobi_mirror(A)
    assert w.shape == (2, 3, n) and V.shape == (2, 3, n, n) and sweeps.shape == (2, 3)
    wp, _ = torch.linalg.eigh(A)
    torch.testing.assert_close(w, wp, rtol=0, atol=1e-12 * float(wp.abs().max()))
    torch.testing.assert_close(V @ torch.diag_embed(w) @ V.mT, _sym_lower(A), rtol=0, atol=1e-12 * 10)


def test_degeneracy_projection_matches_jax(frame_h):
    """`solver.degeneracy_projection` (through the wrapper) against JAX's on
    the frames' H, at a threshold in the widest gap and at one below the
    spectrum, plus a batched call (the solver's batched frames)."""
    for b in range(frame_h.shape[0]):
        H = frame_h[b]
        wp = torch.linalg.eigvalsh(H).numpy()
        for t in (_gap_threshold(wp), 0.5 * float(wp[0])):
            degt, Pt = tsolver.degeneracy_projection(H, t)
            degj, Pj = jsolver.degeneracy_projection(jnp.asarray(H.numpy()), t)
            assert bool(degt) == bool(degj)
            np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), atol=1e-4)
    degt, Pt = tsolver.degeneracy_projection(frame_h, 1.0)
    assert degt.shape == (4,) and Pt.shape == (4, 6, 6)


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises; the
    wrapper checks what the kernel takes (n <= 8, float32 / float64) before
    any launch."""
    before = (small_eigh.eigh.launches, small_eigh.eigvalsh.launches)
    with pytest.raises(ValueError, match="device"):
        small_eigh.eigh(torch.zeros((6, 6), device="meta"))
    with pytest.raises(ValueError, match="n <= 8"):
        small_eigh.eigvalsh(torch.zeros((9, 9), device="meta"))
    with pytest.raises(ValueError, match="float32 or float64"):
        small_eigh.eigh(torch.zeros((6, 6), dtype=torch.float16, device="meta"))
    assert (small_eigh.eigh.launches, small_eigh.eigvalsh.launches) == before


@pytest.mark.parametrize("n", range(1, small_eigh.MAX_N + 1))
def test_jacobi_schedule_is_a_round_robin(n):
    """Every pair of 0..n-1 comes exactly once a sweep, and the pairs within a
    step are disjoint (their rotations act on disjoint planes, so the kernel
    takes their angles side by side): n - 1 steps of n / 2 pairs for even n,
    n steps of (n - 1) / 2 pairs and a bye for odd n."""
    steps = small_eigh.jacobi_schedule(n)
    assert len(steps) == (n if n % 2 else n - 1)
    pairs = sorted((min(p, q), max(p, q)) for step in steps for p, q in step)
    assert pairs == [(p, q) for p in range(n) for q in range(p + 1, n)]
    for step in steps:
        touched = [i for pq in step for i in pq]
        assert len(step) == n // 2 and len(set(touched)) == len(touched), step


def test_mirror_constants_match_the_kernel_source():
    """MAX_N, MAX_SWEEPS and TAU_BIG are the CUDA source's kMaxN,
    kMaxSweeps and TauBig, and its kSchedule table is `jacobi_schedule(n)`
    for every n."""
    src = (Path(small_eigh.__file__).resolve().parent.parent / "csrc" / "small_eigh.cu").read_text()
    assert int(re.search(r"kMaxN = (\d+);", src).group(1)) == small_eigh.MAX_N
    assert int(re.search(r"kMaxSweeps = (\d+);", src).group(1)) == small_eigh.MAX_SWEEPS
    for c_type, dtype in (("float", torch.float32), ("double", torch.float64)):
        big = re.search(rf"TauBig<{c_type}> {{ static constexpr {c_type} value = (0x1p\d+)f?;", src).group(1)
        assert float.fromhex(big) == small_eigh.TAU_BIG[dtype]
    body = re.search(r"kSchedule\[kMaxN\]\[kMaxSteps\]\[kMaxPairs\]\[2\] = (\{.*?\n\});", src, re.S).group(1)
    table = ast.literal_eval(re.sub(r"/\*.*?\*/", "", body).replace("{", "[").replace("}", "]"))
    assert len(table) == small_eigh.MAX_N
    for n in range(1, small_eigh.MAX_N + 1):
        assert [[tuple(pq) for pq in step] for step in table[n - 1]] == small_eigh.jacobi_schedule(n), n
