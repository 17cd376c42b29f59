"""Discrete double-integrator dynamics with K-step propagation operators.

Reference parity: ``workspace/lib/model/src/DoubleIntegrator.cpp`` (get_A0
lines 9-27, get_lambda lines 30-51, applyInput lines 53-63) and
``DoubleIntegratorXYYaw.cpp:9-21``.

Batch-first design notes:
- ``A``, ``B``, ``A0``, ``Lambda`` are *static* operators, precomputed with
  numpy at build time and closed over by jitted functions, so the per-step
  compute is one fused matmul rather than the reference's loop of
  Eigen block writes.
- ``step`` is batched: state arrays carry arbitrary leading axes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import jax.numpy as jnp

from mpc_cbf_tpu.types import State, Array


@dataclasses.dataclass(frozen=True)
class DoubleIntegrator:
    """dim-dimensional discrete double integrator x+ = A x + B u.

    A = [[I, ts*I], [0, I]],  B = [[ts^2/2 * I], [ts * I]]
    (reference DoubleIntegrator.h:79-90, DoubleIntegratorXYYaw.cpp:13-20).
    """

    dim: int
    ts: float

    @property
    def A(self) -> np.ndarray:
        d, ts = self.dim, self.ts
        A = np.eye(2 * d)
        A[:d, d:] = ts * np.eye(d)
        return A

    @property
    def B(self) -> np.ndarray:
        d, ts = self.dim, self.ts
        B = np.zeros((2 * d, d))
        B[:d, :] = 0.5 * ts * ts * np.eye(d)
        B[d:, :] = ts * np.eye(d)
        return B

    def get_A0(self, K: int) -> Tuple[np.ndarray, np.ndarray]:
        """Stacked powers of A: row block k is A^{k+1}.

        Returns (pos, vel), each [dim*K, 2*dim] — the position / velocity
        rows of A^{k+1} (reference get_A0, DoubleIntegrator.cpp:9-27).
        """
        d = self.dim
        pos = np.zeros((d * K, 2 * d))
        vel = np.zeros((d * K, 2 * d))
        prev = np.eye(2 * d)
        for k in range(K):
            new = self.A @ prev
            pos[k * d : (k + 1) * d] = new[:d]
            vel[k * d : (k + 1) * d] = new[d:]
            prev = new
        return pos, vel

    def get_lambda(self, K: int) -> Tuple[np.ndarray, np.ndarray]:
        """Block-Toeplitz input map Λ: x_k = A^k x0 + Σ_j A^{k-1-j} B u_j.

        Returns (pos, vel), each [dim*K, dim*K]
        (reference get_lambda, DoubleIntegrator.cpp:30-51).
        """
        d = self.dim
        pos = np.zeros((d * K, d * K))
        vel = np.zeros((d * K, d * K))
        prev = np.zeros((2 * d, d * K))
        for k in range(K):
            add_b = np.zeros((2 * d, d * K))
            add_b[:, k * d : (k + 1) * d] = self.B
            new = self.A @ prev + add_b
            pos[k * d : (k + 1) * d] = new[:d]
            vel[k * d : (k + 1) * d] = new[d:]
            prev = new
        return pos, vel

    def step(self, state: State, u: Array) -> State:
        """x+ = A x + B u, batched over leading axes.

        (reference applyInput, DoubleIntegrator.cpp:53-63)
        """
        A = jnp.asarray(self.A, dtype=state.pos.dtype)
        B = jnp.asarray(self.B, dtype=state.pos.dtype)
        x = state.stacked
        x1 = x @ A.T + u @ B.T
        return State.from_stacked(x1)

    # Continuous-time drift/actuation used by the CBF engine:
    # xdot = f(x) + g(x) u with f = [vel, 0], g = [[0],[I]]
    # (reference FovCBF.cpp:66-88 — A,B there are the *continuous* pair).
    def f_cont(self, x: Array) -> Array:
        d = self.dim
        return jnp.concatenate([x[..., d:], jnp.zeros_like(x[..., :d])], axis=-1)

    @property
    def g_cont(self) -> np.ndarray:
        d = self.dim
        g = np.zeros((2 * d, d))
        g[d:, :] = np.eye(d)
        return g


def double_integrator_xyyaw(ts: float) -> DoubleIntegrator:
    """The reference's DoubleIntegratorXYYaw: state [px,py,yaw,vx,vy,w],
    u=[ax,ay,alpha] (DoubleIntegratorXYYaw.cpp:9-21)."""
    return DoubleIntegrator(dim=3, ts=ts)
