"""Batched dense linear solves for the f64 solver paths.

``plu_factor``/``plu_solve`` are the polish's KKT solves (ops/qp/polish.py):
batched LU with partial pivoting through ``jax.scipy.linalg``, which XLA
lowers to LAPACK on the CPU and to cuSOLVER on the GPU, in f64 on both.
``spd_solve`` is the batched SPD solve by Cholesky.

The reference pipeline has no counterpart: its exact solves live in CPLEX
(``qpcpp/src/solvers/CPLEX.cpp:35-178``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def plu_factor(A):
    """Batched LU with partial pivoting: A [B, n, n] -> (lu, piv)."""
    return jax.scipy.linalg.lu_factor(A)


def plu_solve(fac, b):
    """Solve with a ``plu_factor`` result; b [B, n] -> x [B, n]."""
    return jax.scipy.linalg.lu_solve(fac, b[..., None])[..., 0]


def spd_solve(M, b, jitter: float = 0.0):
    """Batched SPD solve via Cholesky.

    M [B, k, k] symmetric positive (semi)definite, b [B, k].
    """
    if jitter:
        M = M + jitter * jnp.eye(M.shape[-1], dtype=M.dtype)
    L = jnp.linalg.cholesky(M)
    return jax.scipy.linalg.cho_solve((L, True), b[..., None])[..., 0]
