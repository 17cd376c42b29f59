"""Structure-exploiting batched ADMM for the MPC-CBF QP family.

The dense batched solver (admm.py) treats every problem in the batch as
unrelated: per-problem [n,n] factorizations and per-problem [m,n] matvecs —
thousands of tiny GEMVs that use the matrix units poorly. But across an agent/scenario
batch the MPC QPs share almost everything:

- P (cost quadratic) is identical (slack block is zero),
- the equality rows (init-state eval, continuity), the sampled accel/vel
  bound rows, and the slack-nonnegativity rows have identical
  *coefficients* — only their lb/ub targets differ per agent,
- only the CBF + separating-hyperplane rows (m_d ~ tens) differ per agent.

This module splits A = [A_s (shared, m_s rows); A_d (per-problem, m_d
rows)] and runs the ADMM x-update through the Woodbury identity:

    M_b = M_s + U_b' R_b U_b,   M_s = P + sigma I + A_s' diag(rho_s) A_s
    M_b^{-1} v = Ms_inv v - W_b (C_b)^{-1} W_b' v
    W_b = Ms_inv U_b',   C_b = R_b^{-1} + U_b Ms_inv U_b'

so the O(n^2) and O(n m_s) work per iteration becomes two big shared
matmuls over the whole batch in transposed layout [n, B] / [m_s, B] —
large dense products — while the per-problem work shrinks to
O(m_d n + m_d^2) einsums. Ms_inv is precomputed once at build time in
float64 numpy.

rho is fixed per row class (no per-problem adaptation — that would break
the shared factorization); MPC use warm-starts across steps, where fixed
rho is the standard OSQP regime.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from mpc_cbf_tpu.types import Array, BIG


@dataclasses.dataclass(frozen=True)
class StructuredConfig:
    iters: int = 200
    sigma: float = 1e-6
    rho: float = 0.1
    rho_eq_scale: float = 1e3
    # Two-phase rho schedule, SOFT first then STIFF (see the phase build
    # in __init__): the LAST min(hi_frac*iters, hi_iters_cap) iterations
    # scale rho by rho_hi_scale on the slack-nonnegativity rows
    # (polish_guard_rows) and the dynamic (CBF/Voronoi) rows ONLY —
    # tracking rows keep the soft rho throughout (stiffening them was
    # measured to wreck closed-loop goal tracking). The full (x, z, y)
    # state carries across the switch: the soft phase makes cost/
    # optimality progress, the stiff tail clamps feasibility of the
    # slack-coupled rows from that near-optimal warm state (fov flagship
    # measured 34/64 usable vs 25/64 soft-only). Both Ms_inv
    # factorizations are precomputed at build time — the schedule costs
    # one extra [n,n] matrix and one extra Woodbury precompute, no
    # in-loop work. rho_hi_scale=1 or hi_frac=0 recovers single-phase.
    rho_hi_scale: float = 100.0
    hi_frac: float = 0.5
    hi_iters_cap: int = 50
    # iteration budget for WARM-started tail solves (IMPC iterations > 0,
    # which enter with the previous iterate's primal AND duals): None =
    # same as iters. Consumed by StructuredIMPC, which builds a second
    # operator for the tail; this operator itself always runs cfg.iters.
    iters_tail: Optional[int] = None
    alpha: float = 1.6
    eps_pri: float = 5e-3     # f32 bar (relative)
    refine_steps: int = 1
    # lanes per chunk for the WHOLE solve (lax.map over lane slices).
    # The Woodbury precompute holds ~3 per-lane [m_d, m_d] tensors
    # (Cp, Cp_inv, K) in device memory; at swarm scale they dominate — a
    # 32-agent fov batch of 32768 lanes with m_d = 372 is 3 x 18.9 GB.
    # None = auto: off below m_d = 128, else the largest power of two
    # keeping those tensors within ~2.5 GB (a budget not yet re-measured
    # on the current card: ROADMAP S4). Chunking only engages when it
    # divides the batch.
    lane_chunk: Optional[int] = None
    # f64 active-set polish after the ADMM iterations (ops/qp/polish.py):
    # certifies each lane to f64 optimality (<1e-3 control-deviation bar met
    # from an f32 ADMM entry); lanes that fail certification keep their
    # ADMM iterate. Requires jax_enable_x64.
    polish: bool = False


class StructuredSolution(NamedTuple):
    z: Array          # [B, n]
    pri_res: Array    # [B]
    converged: Array  # met the (loose, f32) ADMM bar — NOT the <1e-3 bar
    # lane certified to f64 optimality by the active-set polish
    # (solve_polished only; always False on the raw ADMM path). converged
    # on a fallback lane means only the ADMM bar — check certified for the
    # exact-oracle (<1e-3 control deviation) guarantee.
    certified: Array
    # duals of the shared/dynamic rows in UNSCALED row coordinates
    # ([B, m_s] / [B, m_d]): feed back as ys0/yd0 to warm-start the next
    # solve of a nearby problem (IMPC iterations, successive replan
    # steps). Unscaled so they survive the per-solve dynamic-row
    # re-equilibration (e_d depends on A_d).
    ys: Array
    yd: Array


class StructuredQPOperator:
    """Shared-structure operator built once per controller configuration.

    P [n, n]; A_s [m_s, n]; eq_mask_s [m_s] marks shared equality rows
    (lb == ub per problem construction — e.g. init/continuity rows).
    """

    #: the f32 ADMM bar is NOT an accuracy certificate; per-lane
    #: certification comes only from solve_polished (Solution.certified)
    certifies = False

    def __init__(self, P: np.ndarray, A_s: np.ndarray, eq_mask_s: np.ndarray,
                 m_d: int, cfg: StructuredConfig = StructuredConfig(),
                 dtype=jnp.float32, q_scale_hint: float = 0.0,
                 polish_guard_rows=(), polish_guard_groups=()):
        n = P.shape[0]
        self.n, self.m_s, self.m_d = n, A_s.shape[0], m_d
        self.cfg = cfg

        # static Ruiz-style equilibration from the shared blocks (float64):
        # variable scaling d from [P; A_s] column norms, row scaling e_s.
        P64, A64 = np.asarray(P, np.float64), np.asarray(A_s, np.float64)
        d = np.ones(n)
        e = np.ones(self.m_s)
        for _ in range(10):
            col = np.maximum(np.abs(P64).max(axis=0), np.abs(A64).max(axis=0) if self.m_s else 0)
            dn = np.where(col > 1e-10, 1.0 / np.sqrt(col), 1.0)
            P64 = dn[:, None] * P64 * dn[None, :]
            A64 = A64 * dn[None, :]
            row = np.abs(A64).max(axis=1)
            en = np.where(row > 1e-10, 1.0 / np.sqrt(row), 1.0)
            A64 = en[:, None] * A64
            d, e = d * dn, e * en
        # cost normalization. The linear term isn't known at build time, so
        # callers pass the magnitude of its largest expected entry (e.g. the
        # slack cost) as q_scale_hint — without it, large linear weights
        # stall the fixed-rho iteration exactly as they did the dense solver
        # before |q|_inf entered its Ruiz gamma.
        q_hint_scaled = q_scale_hint * (np.median(d) if n else 1.0)
        gamma = 1.0 / max(np.abs(P64).max(axis=0).mean(), q_hint_scaled, 1e-12)
        P64 *= gamma

        # unscaled copies for the f64 polish (it re-equilibrates internally)
        self._P0 = np.asarray(P, np.float64)
        self._A_s0 = np.asarray(A_s, np.float64)
        self._n_eq = int(np.sum(eq_mask_s))
        # rows guarding zero-curvature (slack) columns, pre-pinned by the
        # polish so its working-set KKT solves stay bounded; groups list
        # ALL rows touching each such column (coverage invariant)
        self._guard_rows = tuple(int(i) for i in polish_guard_rows)
        self._guard_groups = tuple(tuple(int(i) for i in g)
                                   for g in polish_guard_groups)

        self.D = jnp.asarray(d, dtype)
        self.E_s = jnp.asarray(e, dtype)
        self.gamma = float(gamma)
        self.Pb = jnp.asarray(P64, dtype)
        self.A_sb = jnp.asarray(A64, dtype)

        # phase schedule: (iters, Ms_inv, rho_s, rho_d) per phase — SOFT
        # first (cost/optimality progress), STIFF second (clamps
        # feasibility from the near-optimal warm state). Measured on the
        # fov flagship ensemble (64 problems, 200 iters, f32): soft-only
        # 25/64 usable, slack-scoped soft->stiff 34/64 at cap 50. (Scaling
        # ALL rows reached 55/64 but broke closed-loop goal tracking —
        # see the slack_row note below.) Exact-accuracy fov lanes go
        # through the f64 IPM (ops/qp/ipm.py), not this path.
        iters_hi = (int(round(cfg.iters * cfg.hi_frac))
                    if cfg.rho_hi_scale != 1.0 else 0)
        # the stiff clamp saturates within ~100 iterations; longer budgets
        # should be spent on cost optimality (the soft phase), not here
        iters_hi = min(iters_hi, cfg.iters, cfg.hi_iters_cap)
        # The stiff scale applies ONLY to the constraint families that
        # stall at soft rho — the dynamic (CBF/Voronoi) rows and the slack
        # nonnegativity rows (polish_guard_rows) they couple to. Tracking
        # rows (position/velocity/continuity/bounds) keep the soft rho in
        # both phases: stiffening them was measured to wreck closed-loop
        # goal tracking (connectivity 2r rotate sim overshoots ~1 m past
        # the goal) while buying nothing on the fov usable rate.
        slack_row = np.zeros(self.m_s, bool)
        if len(self._guard_rows):
            slack_row[list(self._guard_rows)] = True
        self.phases = []
        for scale, n_it in ((1.0, cfg.iters - iters_hi),
                            (cfg.rho_hi_scale, iters_hi)):
            if n_it <= 0:
                continue
            rho_s = np.where(eq_mask_s, cfg.rho * cfg.rho_eq_scale,
                             cfg.rho) * np.where(slack_row, scale, 1.0)
            M_s = P64 + cfg.sigma * np.eye(n) + (A64.T * rho_s) @ A64
            self.phases.append((n_it,
                                jnp.asarray(np.linalg.inv(M_s), dtype),
                                jnp.asarray(rho_s, dtype),
                                float(cfg.rho * scale)))
        # aliases for the entry phase (used for warm-start scaling hooks)
        _, self.Ms_inv, self.rho_s, self.rho_d = self.phases[0]

    # ------------------------------------------------------------------
    @partial(jax.jit, static_argnums=(0,))
    def solve(self, q: Array, lb_s: Array, ub_s: Array,
              A_d: Array, lb_d: Array, ub_d: Array,
              x0: Optional[Array] = None,
              ys0: Optional[Array] = None,
              yd0: Optional[Array] = None) -> StructuredSolution:
        """q [B, n]; lb_s/ub_s [B, m_s]; A_d [B, m_d, n]; lb_d/ub_d [B, m_d].

        x0 / ys0 / yd0: optional primal / dual warm starts. Duals are in
        UNSCALED row coordinates (as returned in StructuredSolution.ys/yd
        by a previous solve of a nearby problem); they are rescaled into
        the current equilibration internally.

        Returns primal solutions in the ORIGINAL (unscaled) coordinates.
        """
        with jax.default_matmul_precision("highest"):
            chunk = self._lane_chunk(q.shape[0], jnp.dtype(q.dtype).itemsize)
            if chunk:
                B = q.shape[0]
                # zero warm starts are exactly equivalent to None in
                # _solve, so the mapped tuple can be uniform
                x0f = x0 if x0 is not None else jnp.zeros_like(q)
                ys0f = ys0 if ys0 is not None else jnp.zeros(lb_s.shape, q.dtype)
                yd0f = yd0 if yd0 is not None else jnp.zeros(lb_d.shape, q.dtype)
                resh = lambda a: a.reshape((B // chunk, chunk) + a.shape[1:])
                out = jax.lax.map(
                    lambda t: self._solve(*t),
                    tuple(resh(jnp.asarray(a)) for a in
                          (q, lb_s, ub_s, A_d, lb_d, ub_d, x0f, ys0f, yd0f)))
                return jax.tree.map(
                    lambda a: a.reshape((B,) + a.shape[2:]), out)
            return self._solve(q, lb_s, ub_s, A_d, lb_d, ub_d, x0, ys0, yd0)

    def _lane_chunk(self, B: int, itemsize: int = 4) -> int:
        """Resolved lane-chunk size (0 = no chunking); see lane_chunk.

        itemsize: bytes per element of the solve's compute dtype — under
        jax_enable_x64/f64 the Woodbury tensors are 8 bytes/element and
        the auto budget must halve the lane count accordingly."""
        c = self.cfg.lane_chunk
        if c is None:
            if self.m_d < 128:
                return 0
            per_lane = 3 * itemsize * self.m_d * self.m_d  # 3 [m_d, m_d]
            c = 1 << int(np.floor(np.log2(
                max(2_500_000_000 // per_lane, 256))))
        if c <= 0 or B <= c:
            return 0
        if B % c != 0:
            # a non-dividing batch must NOT silently disable chunking (the
            # unchunked swarm solve is exactly the 3x18.9 GB AOT failure
            # this feature exists to avoid) — fall back to the largest
            # divisor of B that fits the budget
            c = max((d for d in range(1, c + 1) if B % d == 0), default=0)
            if c <= 1:
                return 0
        return c

    def solve_polished(self, q: Array, lb_s: Array, ub_s: Array,
                       A_d: Array, lb_d: Array, ub_d: Array,
                       x0: Optional[Array] = None,
                       ys0: Optional[Array] = None,
                       yd0: Optional[Array] = None,
                       polish_cfg=None) -> StructuredSolution:
        """ADMM entry (any dtype, f32 in production) + f64 active-set polish.

        Each lane is either certified to f64 optimality (converged=True,
        pri_res = its exact relative violation) or falls back to its ADMM
        iterate with the ADMM residual/convergence flags. This is the
        production path matching the reference's exact-CPLEX semantics
        (qpcpp/src/solvers/CPLEX.cpp:35-178) at batch throughput.
        """
        from mpc_cbf_tpu.ops.qp.polish import polish_structured, PolishConfig

        sol = self.solve(q, lb_s, ub_s, A_d, lb_d, ub_d, x0=x0,
                         ys0=ys0, yd0=yd0)
        res = polish_structured(
            self._P0, self._A_s0, q, lb_s, ub_s, A_d, lb_d, ub_d, sol.z,
            polish_cfg if polish_cfg is not None else PolishConfig(),
            max_eq=self._n_eq, guard_rows=self._guard_rows,
            guard_groups=self._guard_groups)
        z = jnp.where(res.ok[:, None], res.z, sol.z.astype(res.z.dtype))
        return StructuredSolution(
            z=z.astype(sol.z.dtype),
            pri_res=jnp.where(res.ok, res.viol.astype(sol.pri_res.dtype),
                              sol.pri_res),
            converged=sol.converged | res.ok,
            certified=res.ok,
            ys=sol.ys, yd=sol.yd,
        )

    def _solve(self, q: Array, lb_s: Array, ub_s: Array,
               A_d: Array, lb_d: Array, ub_d: Array,
               x0: Optional[Array] = None,
               ys0: Optional[Array] = None,
               yd0: Optional[Array] = None) -> StructuredSolution:
        # full-f32 matmuls: at 'default' precision these batched GEMMs run
        # as reduced-precision passes (TF32 on the GPU), which corrupts the
        # Woodbury solve; solve() pins 'highest'
        cfg = self.cfg
        B, n = q.shape
        dt = q.dtype
        D, E_s = self.D, self.E_s

        # scale into equilibrated coordinates
        qb = (q * D[None, :]) * self.gamma                       # [B, n]
        lbs = jnp.maximum(lb_s, -BIG) * E_s[None, :]
        ubs = jnp.minimum(ub_s, BIG) * E_s[None, :]
        # per-row normalization of the dynamic rows (after column scaling)
        Ad = A_d * D[None, None, :]
        row_norm = jnp.max(jnp.abs(Ad), axis=-1)                 # [B, m_d]
        e_d = jnp.where(row_norm > 1e-10, 1.0 / jnp.sqrt(row_norm), 1.0)
        Ad = Ad * e_d[..., None]
        lbd = jnp.maximum(lb_d, -BIG) * e_d
        ubd = jnp.minimum(ub_d, BIG) * e_d
        inactive_d = (lb_d <= -BIG / 2) & (ub_d >= BIG / 2)

        # initial state (transposed layout)
        x = (x0 / D if x0 is not None else jnp.zeros_like(q)).T * 1.0  # [n, B]
        zs = jnp.clip((self.A_sb @ x).T, lbs, ubs)               # [B, m_s]
        zd = jnp.clip(jnp.einsum("bdj,jb->bd", Ad, x), lbd, ubd)
        # dual warm start: incoming duals are UNSCALED (y_u = e·ŷ/γ from a
        # previous solve, possibly under a different dynamic-row
        # equilibration) — map into the current scaled coordinates.
        ys = (ys0 * self.gamma / E_s[None, :]).astype(dt) \
            if ys0 is not None else jnp.zeros_like(zs)
        yd = (yd0 * self.gamma / e_d).astype(dt) \
            if yd0 is not None else jnp.zeros_like(zd)

        # NOTE on duals at the phase switch: the raw y carries over
        # unchanged. Rescaling y to keep the scaled dual u = y/rho
        # continuous looks right on paper but measured strictly worse on
        # both variants (fov 44/64 vs 60/64 usable; connectivity oracle
        # deviation 3e-2 vs 5.9e-4) — the raw duals are the better
        # warm-start information.
        for n_it, Ms_inv, rho_s, rho_d_base in self.phases:
            rho_d = jnp.where(inactive_d, 1e-12, rho_d_base).astype(dt)

            # Woodbury precompute (per problem, ONCE per phase — the inner
            # matrix never changes across iterations, so the whole inner
            # solve is folded into one tensor WK and the loop body is two
            # batched matmuls with no in-loop factorization or
            # triangular solve). W = Ms_inv @ Ad' : [B, n, m_d]
            W = jnp.einsum("ij,bdj->bid", Ms_inv, Ad,
                           preferred_element_type=dt)
            AMA = jnp.einsum("bdj,bje->bde", Ad, W,
                             preferred_element_type=dt)
            # (R^-1 + AMA)^-1 = S (I + S AMA S)^-1 S, S = diag(sqrt(rho)):
            # the scaled form stays well-conditioned even with the 1e-12
            # rho on masked rows (the raw C = R^-1 + AMA has 1e12 diagonal
            # spikes an explicit f32 inverse could not survive)
            sr = jnp.sqrt(rho_d)                                 # [B, m_d]
            Cp = jnp.eye(self.m_d, dtype=dt)[None] \
                + sr[:, :, None] * AMA * sr[:, None, :]
            Cp_inv = jnp.linalg.inv(Cp)
            K = sr[:, :, None] * Cp_inv * sr[:, None, :]         # [B,m_d,m_d]
            WK = jnp.einsum("bid,bde->bie", W, K,
                            preferred_element_type=dt)

            def msolve(RHS_T, Ad=Ad, Ms_inv=Ms_inv, WK=WK):
                """Apply M_b^{-1} to a batch of right-hand sides.

                RHS_T [n, B] transposed layout; returns [n, B].
                """
                S = Ms_inv @ RHS_T                               # [n,B] shared matmul
                t = jnp.einsum("bdj,jb->bd", Ad, S)              # [B, m_d]
                corr = jnp.einsum("bie,be->bi", WK, t)           # [B, n]
                return S - corr.T

            def iteration(carry, _, rho_s=rho_s, rho_d=rho_d, msolve=msolve):
                x, zs, zd, ys, yd = carry
                # rhs = sigma x - q + As'(rho_s zs - ys) + Ad'(rho_d zd - yd)
                rs = (rho_s[None, :] * zs - ys)                  # [B, m_s]
                rd = (rho_d * zd - yd)                           # [B, m_d]
                RHS = cfg.sigma * x - qb.T + self.A_sb.T @ rs.T \
                    + jnp.einsum("bdj,bd->bj", Ad, rd).T         # [n, B]
                xt = msolve(RHS)
                zAs = (self.A_sb @ xt).T                         # [B, m_s]
                zAd = jnp.einsum("bdj,jb->bd", Ad, xt)
                x_new = cfg.alpha * xt + (1 - cfg.alpha) * x
                zs_h = cfg.alpha * zAs + (1 - cfg.alpha) * zs + ys / rho_s[None, :]
                zd_h = cfg.alpha * zAd + (1 - cfg.alpha) * zd + yd / rho_d
                zs_new = jnp.clip(zs_h, lbs, ubs)
                zd_new = jnp.clip(zd_h, lbd, ubd)
                ys_new = ys + rho_s[None, :] * (cfg.alpha * zAs + (1 - cfg.alpha) * zs - zs_new)
                yd_new = yd + rho_d * (cfg.alpha * zAd + (1 - cfg.alpha) * zd - zd_new)
                return (x_new, zs_new, zd_new, ys_new, yd_new), None

            (x, zs, zd, ys, yd), _ = jax.lax.scan(
                iteration, (x, zs, zd, ys, yd), None, length=n_it
            )

        # unscale; primal residual in scaled (row-equilibrated) coordinates,
        # which is the meaningful relative measure
        x_out = (D[:, None] * x).T                               # [B, n]
        As_x = (self.A_sb @ x).T
        Ad_x = jnp.einsum("bdj,jb->bd", Ad, x)
        viol_s = jnp.abs(As_x - jnp.clip(As_x, lbs, ubs))
        viol_d = jnp.abs(Ad_x - jnp.clip(Ad_x, lbd, ubd))
        # per-row relative violation: a 10 m/s^2 miss on a tight row must not
        # be excused by some other row's large magnitude
        rel_s = jnp.max(viol_s / jnp.maximum(jnp.abs(As_x), 1.0), axis=-1)
        rel_d = jnp.max(viol_d / jnp.maximum(jnp.abs(Ad_x), 1.0), axis=-1)
        pri = jnp.maximum(jnp.max(viol_s, axis=-1), jnp.max(viol_d, axis=-1))
        rel = jnp.maximum(rel_s, rel_d)
        return StructuredSolution(
            z=x_out,
            pri_res=pri,
            converged=(rel < cfg.eps_pri) & jnp.all(jnp.isfinite(x_out), axis=-1),
            certified=jnp.zeros(B, bool),
            # duals back to unscaled coordinates (y_u = e·ŷ/γ) so the next
            # solve can rescale them into ITS equilibration
            ys=ys * E_s[None, :] / self.gamma,
            yd=yd * e_d / self.gamma,
        )
