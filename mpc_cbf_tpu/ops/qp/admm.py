"""Batched dense OSQP-style ADMM solver in pure jnp.

Replaces the reference's CPLEX backend (``qpcpp/src/solvers/CPLEX.cpp``).
Where CPLEX runs one active-set solve on one CPU thread (Threads=1,
CPLEX.cpp:118), this solver runs *thousands of QPs in lockstep*: every
operation below is a batched matmul / elementwise op over a leading batch
axis. The batch path is the structure-exploiting solver
(``structured.py``); this dense module is the semantics reference, the
general-QP fallback (arbitrary per-problem P/A), and the per-agent
controller path.

Algorithm (OSQP, Stellato et al. 2020), for
    minimize 0.5 z'Pz + q'z  s.t.  lb <= Az <= ub:

1. Ruiz equilibration of the KKT block [[P, A'], [A, 0]] (fixed number of
   sweeps — static shapes, no data-dependent control flow).
2. Splitting iterations with per-row rho (equality rows get rho * 1e3):
       M = P + sigma*I + A' diag(rho) A        (refactorized per rho update)
       x~ = M^{-1} (sigma*x - q + A'(rho.z - y))
       zA = A x~
       x+ = alpha x~ + (1-alpha) x
       z+ = clip(alpha zA + (1-alpha) z + y/rho, lb, ub)
       y+ = y + rho.(alpha zA + (1-alpha) z - z+)
3. A few adaptive-rho rounds: rho <- rho * sqrt(pri_rel / dua_rel), then
   refactorize. Fixed outer trip count keeps all batch lanes in lockstep;
   convergence is *reported*, never branched on (SURVEY.md §7 hard part (c)).

Warm starting across MPC steps is first-class (x0/y0 args).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

from mpc_cbf_tpu.types import QPBatch, QPSolution, BIG


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    iters: int = 100            # total splitting iterations
    sigma: float = 1e-6
    rho: float = 0.1
    # boost rho on equality rows. OSQP uses 1e3, but through an f32 Cholesky
    # that pushes cond(M) past what 2 refinement passes recover — 1e2 cuts
    # the stalled primal residual ~10x on the MPC-CBF QPs at equal iters.
    rho_eq_scale: float = 1e2
    alpha: float = 1.6          # over-relaxation
    eps_abs: float = 1e-6
    eps_abs_f32: float = 5e-3   # convergence bar in float32 (f32 ADMM floors ~1e-4)
    rho_updates: int = 3        # outer refactorization rounds (1 = fixed rho)
    refine_steps: int = 2       # iterative-refinement passes on the f32 KKT solve
    ruiz_iters: int = 10        # equilibration sweeps (0 = no scaling)
    rho_min: float = 1e-6
    rho_max: float = 1e6


def _ruiz(P, A, q, iters: int):
    """Ruiz equilibration of [[P, A'],[A, 0]] -> (Pb, Ab, D, E, c).

    D scales variables, E scales constraint rows, c scales the cost
    (OSQP §5.1: after D/E sweeps, the cost block is normalized by its mean
    column norm). All loops have static trip counts.
    """
    n, m = P.shape[0], A.shape[0]
    D = jnp.ones(n, P.dtype)
    E = jnp.ones(m, P.dtype)
    c = jnp.asarray(1.0, P.dtype)
    Pb, Ab, qb = P, A, q

    def sweep(carry, _):
        Pb, Ab, qb, D, E, c = carry
        # column inf-norms of the stacked KKT block
        col_var = jnp.maximum(
            jnp.max(jnp.abs(Pb), axis=0), jnp.max(jnp.abs(Ab), axis=0)
        )  # [n]
        col_con = jnp.max(jnp.abs(Ab), axis=1)  # [m]
        # all-zero rows/cols (masked constraints, padding) stay unscaled —
        # dividing by their ~0 norm overflows f32 across sweeps
        d = jnp.where(col_var > 1e-10, 1.0 / jnp.sqrt(jnp.maximum(col_var, 1e-12)), 1.0)
        e = jnp.where(col_con > 1e-10, 1.0 / jnp.sqrt(jnp.maximum(col_con, 1e-12)), 1.0)
        Pb = d[:, None] * Pb * d[None, :]
        Ab = e[:, None] * Ab * d[None, :]
        qb = d * qb
        # cost normalization (OSQP §5.1: include the linear term so large
        # slack weights don't dwarf the quadratic block)
        gamma = 1.0 / jnp.maximum(
            jnp.mean(jnp.max(jnp.abs(Pb), axis=0)) + 1e-12,
            jnp.max(jnp.abs(qb)),
        )
        gamma = jnp.minimum(gamma, 1e8)
        Pb = gamma * Pb
        qb = gamma * qb
        return (Pb, Ab, qb, D * d, E * e, c * gamma), None

    if iters > 0:
        (Pb, Ab, qb, D, E, c), _ = jax.lax.scan(
            sweep, (Pb, Ab, qb, D, E, c), None, length=iters
        )
    return Pb, Ab, qb, D, E, c


def _solve_one(qp: QPBatch, cfg: ADMMConfig, x0, y0):
    """Single-problem ADMM (unbatched); callers vmap."""
    n, m = qp.n, qp.m
    dtype = qp.q.dtype
    eq = (qp.ub - qp.lb) < 1e-12
    inactive = (qp.lb <= -BIG / 2) & (qp.ub >= BIG / 2)

    Pb, Ab, qb, D, E, c = _ruiz(qp.P, qp.A, qp.q, cfg.ruiz_iters)
    lb = E * jnp.maximum(qp.lb, -BIG)
    ub = E * jnp.minimum(qp.ub, BIG)

    rho_row = jnp.where(eq, cfg.rho * cfg.rho_eq_scale, cfg.rho).astype(dtype)
    rho_row = jnp.where(inactive, 1e-12, rho_row)

    # scale warm starts into the equilibrated space
    x = x0 / D
    y = c * y0 / E
    z = jnp.clip(Ab @ x, lb, ub)

    I_n = jnp.eye(n, dtype=dtype)

    # iterative refinement recovers ~double the effective precision of the
    # f32 Cholesky solve when cond(M) approaches 1/eps_f32 (singular P +
    # boosted equality rho make that the common case for the MPC QPs)
    refine = cfg.refine_steps if dtype != jnp.float64 else 0

    def run_round(x, z, y, rho, num_iters):
        M = Pb + cfg.sigma * I_n + (Ab.T * rho) @ Ab
        L = jnp.linalg.cholesky(M)

        def msolve(rhs):
            xt = jsl.cho_solve((L, True), rhs)
            for _ in range(refine):
                xt = xt + jsl.cho_solve((L, True), rhs - M @ xt)
            return xt

        def iteration(carry, _):
            x, z, y = carry
            rhs = cfg.sigma * x - qb + Ab.T @ (rho * z - y)
            xt = msolve(rhs)
            zA = Ab @ xt
            x_new = cfg.alpha * xt + (1 - cfg.alpha) * x
            z_hat = cfg.alpha * zA + (1 - cfg.alpha) * z + y / rho
            z_new = jnp.clip(z_hat, lb, ub)
            y_new = y + rho * (cfg.alpha * zA + (1 - cfg.alpha) * z - z_new)
            return (x_new, z_new, y_new), None

        (x, z, y), _ = jax.lax.scan(iteration, (x, z, y), None, length=num_iters)
        return x, z, y

    rounds = max(cfg.rho_updates, 1)
    per_round = max(cfg.iters // rounds, 1)
    for r in range(rounds):
        x, z, y = run_round(x, z, y, rho_row, per_round)
        if r < rounds - 1:
            # OSQP adaptive rho: ratio of scaled residuals
            Ax = Ab @ x
            pri = jnp.max(jnp.abs(Ax - z))
            pri_sc = jnp.maximum(jnp.max(jnp.abs(Ax)), jnp.max(jnp.abs(z))) + 1e-12
            dua = jnp.max(jnp.abs(Pb @ x + qb + Ab.T @ y))
            dua_sc = (
                jnp.maximum(
                    jnp.maximum(jnp.max(jnp.abs(Pb @ x)), jnp.max(jnp.abs(qb))),
                    jnp.max(jnp.abs(Ab.T @ y)),
                )
                + 1e-12
            )
            scale = jnp.sqrt((pri / pri_sc) / (dua / dua_sc + 1e-18))
            scale = jnp.clip(scale, 0.1, 10.0)
            new_rho = jnp.clip(rho_row * scale, cfg.rho_min, cfg.rho_max)
            rho_row = jnp.where(inactive, 1e-12, new_rho)

    # unscale
    x_out = D * x
    y_out = E * y / c
    Ax = qp.A @ x_out
    viol = jnp.abs(Ax - jnp.clip(Ax, qp.lb, qp.ub))   # per-row violation
    pri = jnp.max(viol)
    Px = qp.P @ x_out
    Aty = qp.A.T @ y_out
    dua = jnp.max(jnp.abs(Px + qp.q + Aty))
    dua_sc = jnp.maximum(
        jnp.maximum(jnp.max(jnp.abs(Px)), jnp.max(jnp.abs(qp.q))),
        jnp.maximum(jnp.max(jnp.abs(Aty)), 1.0),
    )
    # Primal feasibility is the hard requirement (constraint satisfaction)
    # and is checked PER ROW — viol_i <= eps_abs + eps_rel |Ax_i| — so a
    # violated equality row can't hide behind a large-magnitude CBF row
    # (a global max-|Ax| scale masks exactly that). The dual residual only
    # bounds cost suboptimality, and in f32 it floors near 10-15% of scale
    # (cancellation noise in P x + q + A'y at |q| ~ 5e3 — more iterations do
    # NOT reduce it) while the actual cost gap vs the f64 active-set oracle
    # measures ~1e-4 relative and control deviation ~5e-3. So f32 keeps only
    # a coarse dual sanity bar; optimality is validated offline against the
    # oracle (tests/test_oracle_deviation.py), not by the noisy online dual.
    if dtype == jnp.float64:
        eps_pri_abs, eps_pri_rel, eps_dua = cfg.eps_abs * 10, 1e-5, 1e-3
    else:
        eps_pri_abs, eps_pri_rel, eps_dua = cfg.eps_abs_f32, 1e-3, 0.25
    pri_ok = jnp.all(viol <= eps_pri_abs + eps_pri_rel * jnp.abs(Ax))
    return QPSolution(
        z=x_out, y=y_out, pri_res=pri, dua_res=dua,
        converged=pri_ok & (dua < eps_dua * dua_sc)
        & jnp.all(jnp.isfinite(x_out)),
    )


@partial(jax.jit, static_argnames=("cfg",))
def solve_batch(qp: QPBatch, cfg: ADMMConfig = ADMMConfig(),
                x0: Optional[jax.Array] = None, y0: Optional[jax.Array] = None) -> QPSolution:
    """Solve a batch of QPs. Batch axes are all leading axes of qp.q.

    x0/y0: optional warm starts with the same leading axes.
    """
    batch_shape = qp.q.shape[:-1]
    if x0 is None:
        x0 = jnp.zeros_like(qp.q)
    if y0 is None:
        y0 = jnp.zeros_like(qp.lb)

    flat = lambda a, k: a.reshape((-1,) + a.shape[len(batch_shape):]) if batch_shape else a[None]
    qp_f = QPBatch(P=flat(qp.P, 2), q=flat(qp.q, 1), A=flat(qp.A, 2),
                   lb=flat(qp.lb, 1), ub=flat(qp.ub, 1))
    x0_f, y0_f = flat(x0, 1), flat(y0, 1)

    # pin full-f32 matmul precision: at 'default' precision the batched
    # GEMMs may run in reduced precision (TF32 on the GPU), which stalls
    # ADMM around 1e-2 primal residual
    with jax.default_matmul_precision("highest"):
        sol = jax.vmap(lambda P, q, A, lb, ub, x0i, y0i: _solve_one(
            QPBatch(P, q, A, lb, ub), cfg, x0i, y0i))(
            qp_f.P, qp_f.q, qp_f.A, qp_f.lb, qp_f.ub, x0_f, y0_f)

    unflat_v = lambda a: a.reshape(batch_shape + a.shape[1:]) if batch_shape else a[0]
    return QPSolution(
        z=unflat_v(sol.z), y=unflat_v(sol.y),
        pri_res=unflat_v(sol.pri_res), dua_res=unflat_v(sol.dua_res),
        converged=unflat_v(sol.converged),
    )
