"""Parity of the port's geometry core (`pointcloud_slam_tpu_torch.geom`) with
the JAX package's, on the same numpy inputs.

Tolerance: atol 1e-5 unless stated. Both sides evaluate the same float32
formulas; what differs is operation order and fusion (XLA vs eager torch),
a few ulps on O(1) values.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pointcloud_slam_tpu.geom import fit as jfit, s2 as js2, se3 as jse3, so3 as jso3
from pointcloud_slam_tpu_torch.geom import fit as tfit, s2 as ts2, se3 as tse3, so3 as tso3

torch.set_num_threads(2)
ATOL = 1e-5


def _rotvecs(rng, n=64):
    """Rotation vectors over the whole range: tiny, generic and near pi."""
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = np.concatenate([rng.uniform(0, 1e-4, n // 4), rng.uniform(0.1, 2.5, n // 2),
                          rng.uniform(2.5, 3.1, n - n // 4 - n // 2)])
    return (axis * ang[:, None]).astype(np.float32)


def _both(fn_j, fn_t, *args):
    a = fn_j(*(jnp.asarray(x) for x in args))
    b = fn_t(*(torch.from_numpy(np.array(x)) for x in args))
    return a, b


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=atol)


@pytest.mark.parametrize("name", ["hat", "exp", "A_matrix", "vee_hat"])
def test_so3_tangent_maps(rng, name):
    w = _rotvecs(rng)
    if name == "vee_hat":
        a, b = _both(lambda w: jso3.vee(jso3.hat(w)), lambda w: tso3.vee(tso3.hat(w)), w)
    else:
        a, b = _both(getattr(jso3, name), getattr(tso3, name), w)
    _close(a, b)


def test_so3_log(rng):
    # log on exact rotations from numpy (f64 Rodrigues rounded to f32); the
    # near-pi branch is sqrt-sensitive, hence 1e-4 there
    w = _rotvecs(rng)
    R = np.asarray(jso3.exp(jnp.asarray(w, jnp.float32)))
    a, b = _both(jso3.log, tso3.log, R)
    near_pi = np.linalg.norm(w, axis=1) > 2.5
    _close(a[~near_pi], b[~near_pi])
    _close(a[near_pi], b[near_pi], atol=1e-4)


@pytest.mark.parametrize("name", ["boxplus", "boxminus"])
def test_so3_boxplus_boxminus(rng, name):
    Ra = np.asarray(jso3.exp(jnp.asarray(_rotvecs(rng) * 0.5)))
    if name == "boxplus":
        a, b = _both(jso3.boxplus, tso3.boxplus, Ra, _rotvecs(rng) * 0.5)
    else:
        Rb = np.asarray(jso3.exp(jnp.asarray(_rotvecs(rng) * 0.5)))
        a, b = _both(jso3.boxminus, tso3.boxminus, Ra, Rb)
    _close(a, b)


def test_so3_to_quat(rng):
    R = np.asarray(jso3.exp(jnp.asarray(_rotvecs(rng))))
    a, b = _both(jso3.to_quat, tso3.to_quat, R)
    _close(a, b)


def _gravs(rng, n=32):
    g = rng.normal(size=(n, 3))
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    g[0] = [-1.0, 0.0, 0.0]          # the chart's singular direction
    g[1] = [0.0, 0.0, -1.0]          # the resting gravity direction
    return (g * js2.GRAVITY).astype(np.float32)


@pytest.mark.parametrize("name", ["bx", "nx_yy", "normalize"])
def test_s2_charts(rng, name):
    a, b = _both(getattr(js2, name), getattr(ts2, name), _gravs(rng))
    _close(a, b)


@pytest.mark.parametrize("name", ["boxplus", "mx"])
def test_s2_retractions(rng, name):
    g = _gravs(rng)
    delta = (rng.normal(size=(len(g), 2)) * 0.2).astype(np.float32)
    delta[2] = 0.0  # the small-delta branch of mx
    a, b = _both(getattr(js2, name), getattr(ts2, name), g, delta)
    # boxplus returns a gravity vector of norm 9.809: absolute error scales with it
    _close(a, b, atol=1e-4 if name == "boxplus" else ATOL)


def test_s2_boxminus(rng):
    g = _gravs(rng)
    other = np.roll(g, 1, axis=0)
    other[3] = g[3]                   # parallel: zero tangent
    other[4] = -g[4]                  # antiparallel: the degenerate pi branch
    a, b = _both(js2.boxminus, ts2.boxminus, g, other)
    _close(a, b, atol=1e-4)


def test_se3_ops(rng):
    xi = np.concatenate([_rotvecs(rng, 16) * 0.5, rng.normal(size=(16, 3)).astype(np.float32)], axis=1)
    pj, pt = _both(jse3.exp, tse3.exp, xi)
    _close(pj.R, pt.R)
    _close(pj.t, pt.t)
    xi2 = np.roll(xi, 3, axis=0)
    rj = jse3.retract_left(pj, jnp.asarray(xi2))
    rt = tse3.retract_left(pt, torch.from_numpy(xi2))
    _close(rj.R, rt.R)
    _close(rj.t, rt.t)
    cj, ct = pj.compose(rj.inverse()), pt.compose(rt.inverse())
    _close(cj.R, ct.R)
    _close(cj.t, ct.t, atol=1e-4)  # translations are O(1-3) m
    pts = rng.normal(size=(16, 3, 10)).astype(np.float32)
    _close(pj.apply(jnp.asarray(pts)), pt.apply(torch.from_numpy(pts)), atol=1e-4)
    ij, it = jse3.identity(batch=(2,)), tse3.identity(batch=(2,))
    _close(ij.R, it.R)
    _close(ij.t, it.t)


def _sym_components(rng, n=200, repeated=False):
    """Random symmetric 3x3 matrices as components; `repeated` gives
    matrices with a double eigenvalue (planar covariances)."""
    Q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    lam = rng.uniform(0.1, 2.0, size=(n, 3))
    if repeated:
        lam[:, 2] = lam[:, 1]
    A = np.einsum("nij,nj,nkj->nik", Q, lam, Q).astype(np.float32)
    return [A[:, i, j] for (i, j) in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))]


def test_eigh3x3_soa(rng):
    comps = _sym_components(rng)
    (vj, ej), (vt, et) = _both(jfit.eigh3x3_soa, tfit.eigh3x3_soa, *comps)
    _close(vj, vt, atol=1e-5)
    # eigenvectors of separated eigenvalues; Cardano's conditioning scales
    # with 1/gap, so compare where the gaps exceed 0.05
    vals = np.asarray(vj)
    sep = (np.diff(vals, axis=0) > 0.05).all(axis=0)
    _close(ej[..., sep], et[..., sep], atol=1e-4)


def test_eigh3x3_soa_repeated(rng):
    comps = _sym_components(rng, repeated=True)
    (vj, ej), (vt, et) = _both(jfit.eigh3x3_soa, tfit.eigh3x3_soa, *comps)
    # a double root puts Cardano's arccos at +-1, where an ulp of its
    # argument moves the angle by ~sqrt(ulp): 3e-4 on eigenvalues <= 2
    _close(vj, vt, atol=3e-4)
    # the distinct (smallest) eigenvector is well defined; the repeated pair
    # is only defined as a plane, so check the torch basis is orthonormal
    _close(np.abs(np.asarray(ej[0])), torch.abs(et[0]), atol=1e-4)
    gram = torch.einsum("icn,jcn->ijn", et, et)
    np.testing.assert_allclose(gram.numpy(), np.broadcast_to(np.eye(3)[..., None], gram.shape), atol=1e-5)


def test_solve3x3_sym(rng):
    comps = _sym_components(rng)
    rhs = [rng.normal(size=len(comps[0])).astype(np.float32) for _ in range(3)]
    a, b = _both(jfit.solve3x3_sym, tfit.solve3x3_sym, *comps, *rhs)
    for x, y in zip(a, b):
        _close(x, y, atol=1e-4)  # solutions up to ~10 in magnitude (eigenvalues >= 0.1)


def _plane_blocks(rng, n=256, k=5):
    """(3, k, n) neighbourhoods on random planes 1-3 m away, with noise and
    a random validity mask of 2..k points. (Solving A n = -1 in float32 grows
    ill-conditioned with the plane's distance from the origin — a property
    of the reference's esti_plane formulation — so the distances stay where
    both sides agree to rounding.)"""
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    u = np.cross(nrm, rng.normal(size=(n, 3)))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    v = np.cross(nrm, u)
    c = nrm * rng.uniform(1, 3, size=(n, 1))
    s, t = rng.uniform(-0.3, 0.3, size=(2, n, k))
    pts = c[:, None] + s[..., None] * u[:, None] + t[..., None] * v[:, None]
    pts += rng.normal(scale=0.01, size=pts.shape)
    pts[n // 2:, 0] += rng.normal(scale=0.3, size=(n - n // 2, 3))  # outliers: invalid fits
    mask = np.arange(k)[:, None] < rng.integers(2, k + 1, size=n)[None, :]
    return pts.transpose(2, 1, 0).astype(np.float32), mask


def test_plane_fit(rng):
    pts, mask = _plane_blocks(rng)
    (cj, okj), (ct, okt) = _both(jfit.plane_fit, tfit.plane_fit, pts, mask)
    # validity is a threshold test on the worst residual: compare it where
    # that residual is not within rounding (1e-4 m) of the 0.1 m threshold
    cj = np.asarray(cj)
    resid = np.abs(np.einsum("ckn,cn->kn", pts, cj[:3]) + cj[3])
    worst = np.where(mask, resid, 0.0).max(axis=0)
    clear = np.abs(worst - 0.1) > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(okt.numpy()[clear], np.asarray(okj)[clear])
    # the adjugate solve of A n = -1 cancels ~3 digits (det is a difference
    # of O(1e3) products), so ulp-level differences in the two sides' sums
    # reach ~1e-3 in the coefficients
    _close(cj, ct, atol=5e-3)


def test_plane_fit_degenerate(rng):
    """Collinear, coincident, all-masked and too-few-point neighbourhoods:
    validity flags equal and coefficients equal (finite) on both sides."""
    k = 5
    line = np.stack([np.linspace(0, 1, k)] * 3, axis=0)            # collinear
    same = np.ones((3, k)) * 2.0                                    # coincident
    plane = np.stack([rng.uniform(-1, 1, k), rng.uniform(-1, 1, k), np.full(k, 3.0)])
    origin = np.stack([rng.uniform(-1, 1, k), rng.uniform(-1, 1, k), np.zeros(k)])  # plane through 0
    pts = np.stack([line, same, plane, plane, origin], axis=-1).astype(np.float32)  # (3, k, 5)
    mask = np.ones((k, 5), bool)
    mask[:, 2] = False          # nothing valid
    mask[2:, 3] = False         # two points < min_pts
    (cj, okj), (ct, okt) = _both(jfit.plane_fit, tfit.plane_fit, pts, mask)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert np.all(np.isfinite(ct.numpy()))
    _close(cj, ct, atol=1e-3)   # the near-singular solves amplify rounding
