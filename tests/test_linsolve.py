"""Batched f64 LU (ops/qp/linsolve.py) on the polish's KKT shapes.

``plu_factor``/``plu_solve`` are what the active-set polish solves its
Jacobi-scaled working-set KKT systems with (ops/qp/polish.py). The cases
below are those shapes: symmetric quasi-definite with a wide diagonal
span, a permuted one that needs row pivoting, and a near-singular one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_cbf_tpu.ops.qp.linsolve import plu_factor, plu_solve, spd_solve

pytestmark = pytest.mark.usefixtures("x64")


@pytest.fixture
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def _random_kkt_like(rng, B, n, span=8.0):
    """Symmetric quasi-definite batch with a wide diagonal span, like the
    polish KKT (polish.py builds exactly this shape)."""
    Q = rng.normal(size=(B, n, n))
    A = (Q + np.swapaxes(Q, 1, 2)) / 2
    d = 10.0 ** rng.uniform(-span / 2, span / 2, size=(B, n))
    return A + np.apply_along_axis(np.diag, 1, d * np.sign(rng.normal(size=(B, n))))


def _jacobi(A):
    s = 1.0 / np.sqrt(np.maximum(np.abs(A).max(axis=2), 1e-12))
    return s[:, :, None] * A * s[:, None, :]


def _case(name):
    rng = np.random.default_rng({"random": 0, "permuted": 1, "near_singular": 2}[name])
    if name == "random":
        # the polish's KKT width for the fov flagship: n = 43 plus a
        # 24-row pool beyond the equality rows
        return _jacobi(_random_kkt_like(rng, 16, 67, span=6.0))
    if name == "permuted":
        # rows shuffled off the dominant diagonal: pivoting must find them
        A = _random_kkt_like(rng, 4, 12, span=4.0)
        perm = rng.permutation(12)
        return _jacobi(A[:, perm])
    # one pivot many orders below the rest: the dual-regularized pinned
    # rows (PolishConfig.delta = 1e-13) put exactly such a pivot in K
    noise = 1e-3 * _random_kkt_like(rng, 2, 9, span=0.0)
    noise[:, 4, :] = noise[:, :, 4] = 0.0
    A = np.tile(np.eye(9), (2, 1, 1)) + noise
    A[:, 4, 4] = 1e-13
    return A


@pytest.mark.parametrize("name", ["random", "permuted", "near_singular"])
def test_plu_solves_polish_kkt_shapes(name):
    A = jnp.asarray(_case(name), jnp.float64)
    B, n, _ = A.shape
    b = jnp.asarray(np.random.default_rng(5).normal(size=(B, n)), jnp.float64)
    x = plu_solve(plu_factor(A), b)
    assert x.dtype == jnp.float64 and x.shape == (B, n)
    assert bool(jnp.all(jnp.isfinite(x)))
    # backward error at f64 rounding, scaled by the system's size
    resid = np.asarray(jnp.einsum("bij,bj->bi", A, x) - b)
    scale = np.abs(np.asarray(A)).max(axis=(1, 2)) * np.abs(np.asarray(x)).max(axis=1)
    assert (np.abs(resid).max(axis=1) / np.maximum(scale, 1.0)).max() < 1e-12
    np.testing.assert_allclose(np.asarray(x), np.linalg.solve(np.asarray(A), np.asarray(b)[..., None])[..., 0],
                               rtol=1e-6, atol=1e-8)


def test_spd_solve_matches_direct():
    rng = np.random.default_rng(3)
    G = rng.normal(size=(8, 20, 6))
    M = jnp.asarray(np.einsum("bij,bkj->bik", G, G), jnp.float64) \
        + 1e-3 * jnp.eye(20)
    b = jnp.asarray(rng.normal(size=(8, 20)), jnp.float64)
    x = spd_solve(M, b)
    x_ref = jnp.linalg.solve(M, b[..., None])[..., 0]
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_ref),
                               rtol=1e-8, atol=1e-10)
