"""Batched Mehrotra predictor–corrector interior-point method (f64).

The CERTIFIED-accuracy solver for the structured MPC-CBF QP family — the
role CPLEX plays in the reference (``qpcpp/src/solvers/CPLEX.cpp:35-178``:
exact convex QP, one problem at a time, single thread). This is its
batched replacement: thousands of lanes solved in lockstep, every
per-iteration operation a batched matmul or an [nz, nz] Cholesky with
nz ≈ 20.

Problem family (same as ops/qp/structured.py):

    min ½ xᵀPx + qᵀx
    s.t. lb_s ≤ A_s x ≤ ub_s     (shared rows; eq_mask marks lb == ub)
         lb_d ≤ A_d x ≤ ub_d     (per-lane rows: CBF / Voronoi)

Design — why this batches well:

1. **Equality elimination by a static nullspace basis.** The equality
   rows (init state, continuity) have a SHARED coefficient matrix E with
   per-lane targets b. At build time we factor E = U Σ Vᵀ once and
   parameterize x = E⁺b + Z v with Z = null(E). The IPM then runs in the
   reduced coordinate v (nz = n − rank(E) ≈ 20 for the flagship), so the
   per-iteration KKT system is an [nz, nz] Cholesky instead of an
   [n+me, n+me] indefinite factorization — ~10× fewer flops and no
   pivoting, which is exactly what batched linear algebra wants.
2. **Everything else is two-sided inequalities** handled OOQP-style with
   slack t and duals (z_l, z_u); one-sided / masked rows are static
   masks, so a single compiled program serves every neighbor count.
3. **Fixed iteration count under `lax.scan`**, per-lane convergence
   flags; converged lanes freeze (α = 0) so late iterations cannot
   destabilize finished lanes.

Accuracy: μ is driven to ~1e-10 (relative), giving control deviations
~1e-8 vs the native exact oracle — far inside the 1e-3 production bar —
from a COLD start in ~25 iterations (tests/test_ipm.py, fov flagship).
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
class IPMConfig:
    iters: int = 30
    tau: float = 0.995        # fraction-to-boundary
    eps_mu: float = 1e-10     # complementarity bar (relative to cost scale)
    eps_feas: float = 1e-9    # primal residual bar (relative)
    #: stationarity bar (scaled coordinates, cost normalized to O(1)).
    #: Calibrated on the fov flagship vs the exact oracle: the measured
    #: worst-case slope of control deviation vs dual residual is ~7e2
    #: (dual 3.5e-6 -> dev 2.4e-3; dual 2.3e-7 -> dev 3.0e-5), so
    #: eps_dual = 1e-6 certifies deviation <~ 7e-4 on NON-degenerate
    #: lanes. Lanes freeze at eps-level mu with r_d in the 1e-8..2e-7
    #: range on degenerate slack-heavy problems; a 1e-8-scale dual bar
    #: would reject lanes whose actual deviation is ~1e-5. Caveat: no
    #: residual bar can bound deviation on DEGENERATE lanes (~1-3% of
    #: random fov lanes) — rank-decayed slack weights leave near-flat
    #: optimal faces where a fully-converged lane (mu 4e-13, dual 5e-10)
    #: still sits ~2e-3 from the oracle's equally-optimal point. The
    #: honest certificate is two-part: deviation < 1e-3 OR e-equal-
    #: optimal (feasible + objective matches the oracle's to ~1e-7
    #: relative, measured) — pinned by tests/test_ipm.py::
    #: test_hybrid_ipm_fov_flagship_certifies across seeds.
    eps_dual: float = 1e-6
    reg: float = 1e-11        # static Tikhonov term on the reduced Hessian
    #: lanes whose μ drops below this freeze (α := 0) — keeps nearly-exact
    #: lanes from seesawing once D spans ~1e12 of dynamic range
    mu_freeze: float = 1e-12
    #: lanes per chunk through lax.map (bounds the [B, m, nz] temporaries;
    #: 0 disables chunking). Not yet re-measured on the current card
    #: (ROADMAP S4).
    chunk: int = 2048
    #: debug: print per-iteration (mu, |r_d|, |r_p|, a_p, a_d)
    trace: bool = False
    #: warm-start (state0) interiorization pad: transferred slacks are
    #: pushed at least this far inside their bounds. 1e-10 suits same-
    #: dtype transfers; the f32 -> f64 hybrid needs ~1e-6 (the f32 state
    #: carries rounding-noise boundary contact that collapses the first
    #: f64 steps — measured 0.656 -> 0.984 converged on the fov flagship)
    warm_pad: float = 1e-10
    #: >0 enables neighborhood projection of transferred duals: each
    #: complementarity product g*z is clipped into
    #: [mu_t/width, width*mu_t] with mu_t = max(lane mu, warm_mu_floor).
    #: An f32 entry state is off-path in its SMALL coordinates; restarting
    #: centered at mu_t lets Mehrotra converge in ~10 f64 iterations
    #: instead of ~30 from cold (Gondzio-style warm-start centering)
    warm_center_width: float = 0.0
    warm_mu_floor: float = 1e-4
    #: "f64" (the certified path) or "f32". The f32 profile exists to run
    #: the SAME algorithm at f32 speed as an ENTRY-POINT
    #: generator for the f64 tail (HybridIPM below): at f32
    #: precision μ bottoms out near ~1e-6, which is orders closer to the
    #: optimum than an f32 ADMM iterate and identifies the active set
    #: crisply. Never certified by itself — pair with loosened bars, e.g.
    #: IPM_F32_ENTRY below.
    dtype: str = "f64"


#: entry-profile configuration for the f32 IPM (see IPMConfig.dtype)
IPM_F32_ENTRY = None  # set after IPMConfig is defined (below)


IPM_F32_ENTRY = IPMConfig(
    iters=22, eps_mu=1e-5, eps_feas=1e-5, eps_dual=1e-3,
    reg=1e-6, mu_freeze=1e-7, dtype="f32")


class IPMSolution(NamedTuple):
    z: Array          # [B, n] primal solution, ORIGINAL coordinates, f64
    converged: Array  # [B] met the μ + primal AND dual feasibility bars
    mu: Array         # [B] final (scaled) complementarity measure
    pri_res: Array    # [B] relative bound violation of z
    dual_res: Array   # [B] stationarity residual (scaled coordinates)
    #: final interior state (v, t, zl, zu) in SCALED coordinates — feed as
    #: ``state0`` to another StructuredIPM over the same problem family
    #: (the hybrid f32 -> f64 pipeline, HybridIPM below; both
    #: operators derive identical scalings from the same inputs, so the
    #: state transfers across dtype to ~1e-7 relative)
    state: tuple


class StructuredIPM:
    """Build-once operator for a fixed (P, A_s, eq_mask, m_d) family.

    Mirrors StructuredQPOperator's interface so StructuredIMPC can swap it
    in via StructuredConfig(method="ipm"). Requires jax_enable_x64.
    """

    def __init__(self, P: np.ndarray, A_s: np.ndarray, eq_mask_s: np.ndarray,
                 m_d: int, cfg: IPMConfig = IPMConfig()):
        #: only the f64 profiles' convergence bars are deviation-
        #: calibrated certificates; an f32 profile's `converged` means
        #: "reached the f32 floor", never <1e-3 accuracy
        self.certifies = cfg.dtype == "f64"
        if cfg.dtype == "f64" and not jax.config.jax_enable_x64:
            raise RuntimeError(
                "StructuredIPM is the f64 certified path; enable "
                "jax_enable_x64 (see ops/qp/polish.py for the same rule). "
                "(The f32 entry profile sets IPMConfig(dtype='f32').)")
        n = P.shape[0]
        self.n, self.m_d = n, m_d
        self.cfg = cfg
        eq = np.asarray(eq_mask_s, bool)
        P64 = np.asarray(P, np.float64)
        A64 = np.asarray(A_s, np.float64)

        # nullspace factorization of the equality block (static)
        E = A64[eq]
        me = E.shape[0]
        if me:
            U, s, Vt = np.linalg.svd(E, full_matrices=True)
            rank = int(np.sum(s > s[0] * 1e-12)) if s.size else 0
            self._Epinv = (Vt[:rank].T / s[:rank]) @ U[:, :rank].T  # [n, me]
            Z = Vt[rank:].T                                         # [n, nz]
        else:
            self._Epinv = np.zeros((n, 0))
            Z = np.eye(n)
        self.nz = Z.shape[1]
        self._Z = Z
        self._Pt = Z.T @ P64 @ Z                   # [nz, nz]
        self._PZ = P64 @ Z                         # [n, nz] (for q̃ = Zᵀ(q + P x_p))
        self._Gs = A64[~eq]                        # [m_si, n]
        self._GsZ = self._Gs @ Z                   # [m_si, nz]
        self._eq = eq
        self.m_si = self._Gs.shape[0]

        # static row scaling for the shared inequality rows
        rs = np.abs(self._GsZ).max(axis=1)
        self._es = np.where(rs > 1e-12, 1.0 / np.maximum(rs, 1e-12), 1.0)

        # compute dtype: the f64 certified path, or the f32 entry profile
        # (precompute above is always float64 numpy)
        self.dt = jnp.float64 if cfg.dtype == "f64" else jnp.float32
        dt = self.dt
        self.Zb = jnp.asarray(Z, dt)
        self.Ptb = jnp.asarray(self._Pt, dt)
        self.PZb = jnp.asarray(self._PZ, dt)
        self.Epinvb = jnp.asarray(self._Epinv, dt)
        self.GsZb = jnp.asarray(self._GsZ * self._es[:, None], dt)
        self.esb = jnp.asarray(self._es, dt)
        self.eq_idx = jnp.asarray(np.nonzero(eq)[0], jnp.int32)
        self.ineq_idx = jnp.asarray(np.nonzero(~eq)[0], jnp.int32)
        self._pmax = float(max(np.abs(self._Pt).max(), 1e-12))

    # ------------------------------------------------------------------
    @partial(jax.jit, static_argnums=(0,))
    def solve(self, q: Array, lb_s: Array, ub_s: Array,
              A_d: Array, lb_d: Array, ub_d: Array,
              x0: Optional[Array] = None,
              ys0: Optional[Array] = None,
              yd0: Optional[Array] = None,
              state0=None) -> IPMSolution:
        """q [B, n]; lb_s/ub_s [B, m_s]; A_d [B, m_d, n]; lb_d/ub_d [B, m_d].

        ys0/yd0 are accepted for interface parity with
        StructuredQPOperator and ignored, like x0 (see below).

        state0: (v, t, zl, zu) interior state from another StructuredIPM's
        IPMSolution.state over the SAME lanes — the hybrid pipeline's
        on-central-path warm start (unlike the primal-only x0 below, this
        carries the full path state and does not suffer the classic
        off-path warm-start penalty)."""
        args = tuple(jnp.asarray(a, self.dt)
                     for a in (q, lb_s, ub_s, A_d, lb_d, ub_d))
        # x0 is accepted for interface parity with StructuredQPOperator but
        # IGNORED: primal-only warm starts measurably HURT interior-point
        # convergence here (worst-lane deviation 9.9 warm vs 1.1 cold at a
        # 10-iteration budget, fov flagship — the off-central-path start
        # costs more than the primal information buys; the well-known IPM
        # warm-start problem). The cold central-path start converges in
        # ~18 iterations, which IS the production configuration.
        if state0 is not None:
            state0 = tuple(jnp.asarray(a, self.dt) for a in state0)
        B = args[0].shape[0]
        chunk = self.cfg.chunk
        # full-precision products whatever the embedding application set:
        # at 'default' an f32 GEMM may run in TF32 on the GPU
        with jax.default_matmul_precision("highest"):
            if chunk and B > chunk and B % chunk == 0:
                resh = lambda a: a.reshape((B // chunk, chunk) + a.shape[1:])
                packed = tuple(resh(a) for a in args) \
                    + (tuple(resh(a) for a in state0) if state0 is not None else ())
                out = jax.lax.map(
                    lambda t: self._solve(*t[:6],
                                          t[6:10] if len(t) > 6 else None),
                    packed)
                flat = lambda a: a.reshape((B,) + a.shape[2:])
                return jax.tree.map(flat, IPMSolution(*out))
            return self._solve(*args, state0)

    def _solve(self, q, lb_s, ub_s, A_d, lb_d, ub_d, state0):
        cfg = self.cfg
        f64 = self.dt   # compute dtype (f64 certified / f32 entry profile)
        B = q.shape[0]
        nz, m_si, m_d = self.nz, self.m_si, self.m_d
        m = m_si + m_d

        # particular solution of the equality block, reduced cost
        b_e = lb_s[:, self.eq_idx]                          # [B, me]
        x_p = b_e @ self.Epinvb.T                           # [B, n]
        q_t = q @ self.Zb + x_p @ self.PZb                  # Zᵀq + ZᵀP x_p
        # per-lane cost normalization (primal-invariant): keeps μ and the
        # dual residual O(1) even with 5e4-scale slack weights — the same
        # rule the native oracle applies (native/qp_oracle.cpp qp_solve)
        gamma = 1.0 / jnp.maximum(jnp.max(jnp.abs(q_t), axis=1),
                                  self._pmax)               # [B]
        q_t = q_t * gamma[:, None]

        # reduced, row-scaled inequality system G v ∈ [l, u]
        GdZ = jnp.einsum("bmn,nk->bmk", A_d, self.Zb,
                         preferred_element_type=f64)        # [B, m_d, nz]
        ed = 1.0 / jnp.maximum(jnp.max(jnp.abs(GdZ), axis=2), 1e-12)
        GdZ = GdZ * ed[:, :, None]
        Gxp_s = x_p @ self._asGs().T                        # [B, m_si] (scaled rows)
        Gxp_d = jnp.einsum("bmn,bn->bm", A_d, x_p) * ed
        l_si = (lb_s[:, self.ineq_idx]) * self.esb[None, :] - Gxp_s
        u_si = (ub_s[:, self.ineq_idx]) * self.esb[None, :] - Gxp_s
        l_d = lb_d * ed - Gxp_d
        u_d = ub_d * ed - Gxp_d
        l = jnp.concatenate([l_si, l_d], axis=1)            # [B, m]
        u = jnp.concatenate([u_si, u_d], axis=1)
        # side masks: a bound beyond BIG/2 (pre-scaling) is absent
        has_l = jnp.concatenate([lb_s[:, self.ineq_idx] > -BIG / 2,
                                 lb_d > -BIG / 2], axis=1)
        has_u = jnp.concatenate([ub_s[:, self.ineq_idx] < BIG / 2,
                                 ub_d < BIG / 2], axis=1)
        n_comp = jnp.maximum(jnp.sum(has_l, 1) + jnp.sum(has_u, 1), 1)

        def matvec(V):                                      # [B, nz] -> [B, m]
            return jnp.concatenate(
                [V @ self.GsZb.T,
                 jnp.einsum("bmk,bk->bm", GdZ, V)], axis=1)

        def rmatvec(Y):                                     # [B, m] -> [B, nz]
            return Y[:, :m_si] @ self.GsZb \
                + jnp.einsum("bmk,bm->bk", GdZ, Y[:, m_si:])

        if state0 is not None:
            # on-central-path warm start from another dtype's run over the
            # same lanes: re-interiorize against THIS solve's (l, u) —
            # dtype rounding can leave t marginally outside — and floor
            # the duals so the first Newton system stays finite
            v, t, zl, zu = state0
            pad = jnp.minimum(cfg.warm_pad, 0.25 * jnp.where(
                has_l & has_u, u - l, jnp.inf))
            t = jnp.clip(t,
                         jnp.where(has_l, l + pad, -jnp.inf),
                         jnp.where(has_u, u - pad, jnp.inf))
            # NO lower floor on the duals: z = 0 is safe (D-contribution 0;
            # the corrector's -sm/g term steps such duals back inside), and
            # a uniform floor puts eps * gap of complementarity mass on
            # near-unbounded rows (gap ~ 1e12 -> floored mu ~ 1e2,
            # measured — it wrecked the transfer entirely)
            zl = jnp.where(has_l, jnp.clip(zl, 0.0, 1e12), 0.0)
            zu = jnp.where(has_u, jnp.clip(zu, 0.0, 1e12), 0.0)
            if cfg.warm_center_width > 0:
                # neighborhood projection (see IPMConfig.warm_center_width)
                g_lw = jnp.where(has_l, t - l, 1.0)
                g_uw = jnp.where(has_u, u - t, 1.0)
                mu_w = (jnp.sum(g_lw * zl * has_l, 1)
                        + jnp.sum(g_uw * zu * has_u, 1)) / n_comp
                mu_w = jnp.maximum(mu_w, cfg.warm_mu_floor)[:, None]
                w = cfg.warm_center_width
                zl = jnp.where(has_l,
                               jnp.clip(zl, mu_w / (w * g_lw), w * mu_w / g_lw),
                               0.0)
                zu = jnp.where(has_u,
                               jnp.clip(zu, mu_w / (w * g_uw), w * mu_w / g_uw),
                               0.0)
        else:
            # strictly interior cold start (see solve() for why never warm)
            v = jnp.zeros((B, nz), f64)
            Gv = matvec(v)
            gap = jnp.where(has_l & has_u, u - l, jnp.inf)
            delta = jnp.minimum(1.0, 0.25 * gap)
            t = jnp.clip(Gv,
                         jnp.where(has_l, l + jnp.where(jnp.isfinite(delta), delta, 1.0), -jnp.inf),
                         jnp.where(has_u, u - jnp.where(jnp.isfinite(delta), delta, 1.0), jnp.inf))
            mu0 = 1.0
            # centered duals: g∘z = μ0 per present side. Row gaps span ~9
            # orders of magnitude (CBF bounds vs unit boxes after row
            # scaling); z = 1 would put μ0 at ~1e10 and waste ~15
            # iterations crawling back to the central path (measured on
            # the fov flagship). z = μ0/g starts ON the central path.
            g_l0 = jnp.where(has_l, t - l, 1.0)
            g_u0 = jnp.where(has_u, u - t, 1.0)
            zl = jnp.where(has_l, jnp.clip(mu0 / g_l0, 1e-10, 1e10), 0.0)
            zu = jnp.where(has_u, jnp.clip(mu0 / g_u0, 1e-10, 1e10), 0.0)

        Pg = self.Ptb[None] * gamma[:, None, None]          # [B, nz, nz]
        eyef = jnp.eye(nz, dtype=f64)

        tiny = float(jnp.finfo(f64).tiny)

        def body(carry, _):
            v, t, zl, zu, frozen = carry
            Gv = matvec(v)
            g_l = jnp.where(has_l, t - l, 1.0)
            g_u = jnp.where(has_u, u - t, 1.0)
            r_d = jnp.einsum("bij,bj->bi", Pg, v) + q_t - rmatvec(zl - zu)
            r_p = Gv - t
            mu = (jnp.sum(g_l * zl * has_l, 1)
                  + jnp.sum(g_u * zu * has_u, 1)) / n_comp
            # freeze BEFORE stepping: once μ is at the floor, D spans
            # ~1e15 of dynamic range and further steps can poison the
            # state (NaN duals observed) — a frozen lane keeps its
            # (already certified) iterate untouched. The freeze stays on
            # μ ALONE deliberately: continuing to iterate from a
            # collapsed μ degrades the primal even when r_d is unmet
            # (measured on the fov flagship: freezing only at
            # μ∧dual-feasible let 28/64 lanes keep stepping and pushed
            # worst-lane control deviation from 8e-4 to 2.4e-3). A lane
            # frozen with stationarity unmet is instead EXCLUDED from
            # `converged` by the dual bar in the final diagnostics.
            frozen = frozen | (mu < cfg.mu_freeze)

            D = jnp.where(has_l, zl / g_l, 0.0) + jnp.where(has_u, zu / g_u, 0.0)
            H = Pg + cfg.reg * eyef[None] \
                + jnp.einsum("mi,bm,mj->bij", self.GsZb, D[:, :m_si],
                             self.GsZb, preferred_element_type=f64) \
                + jnp.einsum("bmi,bm,bmj->bij", GdZ, D[:, m_si:], GdZ,
                             preferred_element_type=f64)
            # library Cholesky (LAPACK / cuSOLVER); a non-SPD lane
            # factors to NaN, which the finite-step guard below freezes
            L = jnp.linalg.cholesky(H)
            solve_L = lambda rhs: jax.scipy.linalg.cho_solve(
                (L, True), rhs[..., None])[..., 0]

            def kkt_solve(rc_l, rc_u):
                rhs = -r_d - rmatvec(
                    jnp.where(has_l, rc_l / g_l, 0.0)
                    - jnp.where(has_u, rc_u / g_u, 0.0) + D * r_p)
                dv = solve_L(rhs)
                dt = matvec(dv) + r_p
                dz_l = jnp.where(has_l, -(rc_l + zl * dt) / g_l, 0.0)
                dz_u = jnp.where(has_u, -(rc_u - zu * dt) / g_u, 0.0)
                return dv, dt, dz_l, dz_u

            def max_step(g_l, g_u, zl, zu, dt, dz_l, dz_u):
                # largest α keeping slacks/duals positive (per lane)
                def ratio(x, dx, present):
                    r = jnp.where(present & (dx < 0), -x / jnp.minimum(dx, -tiny), jnp.inf)
                    return jnp.min(r, axis=1)
                a_p = jnp.minimum(ratio(g_l, dt, has_l), ratio(g_u, -dt, has_u))
                a_d = jnp.minimum(ratio(zl, dz_l, has_l), ratio(zu, dz_u, has_u))
                return jnp.minimum(a_p, 1.0), jnp.minimum(a_d, 1.0)

            # predictor
            dv_a, dt_a, dzl_a, dzu_a = kkt_solve(g_l * zl, g_u * zu)
            a_p, a_d = max_step(g_l, g_u, zl, zu, dt_a, dzl_a, dzu_a)
            a = jnp.minimum(a_p, a_d)[:, None]
            mu_aff = (jnp.sum((g_l + a * dt_a) * (zl + a * dzl_a) * has_l, 1)
                      + jnp.sum((g_u - a * dt_a) * (zu + a * dzu_a) * has_u, 1)) / n_comp
            sigma = jnp.clip(mu_aff / jnp.maximum(mu, tiny), 0.0, 1.0) ** 3

            # corrector
            sm = (sigma * mu)[:, None]
            dv, dt, dz_l, dz_u = kkt_solve(
                g_l * zl - sm + dt_a * dzl_a,
                g_u * zu - sm - dt_a * dzu_a)
            a_p, a_d = max_step(g_l, g_u, zl, zu, dt, dz_l, dz_u)
            # Equalize strongly asymmetric steps: when a_p and a_d differ
            # by >5x, the larger side races ahead and μ collapses with the
            # dual residual stalled — the lane then freezes non-stationary
            # (up to 2.4e-3 control deviation observed on a degenerate fov
            # lane certified-looking at μ=5e-11). Locking both sides to
            # min(a_p, a_d) in that regime keeps μ and r_d falling
            # together; symmetric lanes keep Mehrotra's separate steps.
            a_eq = jnp.minimum(a_p, a_d)
            asym = a_eq < 0.2 * jnp.maximum(a_p, a_d)
            a_p = jnp.where(asym, a_eq, a_p)
            a_d = jnp.where(asym, a_eq, a_d)
            step_ok = jnp.all(jnp.isfinite(dv), axis=1) \
                & jnp.all(jnp.isfinite(dt), axis=1) \
                & jnp.all(jnp.isfinite(dz_l) & jnp.isfinite(dz_u), axis=1) \
                & ~frozen
            a_p = jnp.where(step_ok, cfg.tau * a_p, 0.0)[:, None]
            a_d = jnp.where(step_ok, cfg.tau * a_d, 0.0)[:, None]

            # mask the deltas, not just α: 0 * NaN = NaN, and a frozen
            # lane's KKT solve is allowed to produce NaN directions
            ok = step_ok[:, None]
            v = v + jnp.where(ok, a_p * dv, 0.0)
            t = t + jnp.where(ok, a_p * dt, 0.0)
            zl = jnp.where(has_l, zl + jnp.where(ok, a_d * dz_l, 0.0), 0.0)
            zu = jnp.where(has_u, zu + jnp.where(ok, a_d * dz_u, 0.0), 0.0)
            aux = (mu, jnp.max(jnp.abs(r_d), 1), jnp.max(jnp.abs(r_p), 1),
                   a_p[:, 0], a_d[:, 0]) if cfg.trace else None
            return (v, t, zl, zu, frozen), aux

        frozen0 = jnp.zeros(B, bool)
        (v, t, zl, zu, _), self_trace = jax.lax.scan(
            body, (v, t, zl, zu, frozen0), None, length=cfg.iters)
        if cfg.trace:
            jax.debug.print(
                "IPM trace (mu / |r_d| / |r_p| / a_p / a_d per iter):\n{t}",
                t=self_trace)

        # final diagnostics in scaled coordinates
        Gv = matvec(v)
        g_l = jnp.where(has_l, t - l, 1.0)
        g_u = jnp.where(has_u, u - t, 1.0)
        mu = (jnp.sum(g_l * zl * has_l, 1) + jnp.sum(g_u * zu * has_u, 1)) / n_comp
        r_d = jnp.einsum("bij,bj->bi", Pg, v) + q_t - rmatvec(zl - zu)
        bscale = jnp.maximum(1.0, jnp.maximum(
            jnp.where(has_l, jnp.abs(l), 0.0), jnp.where(has_u, jnp.abs(u), 0.0)))
        viol = jnp.maximum(jnp.where(has_l, l - Gv, 0.0),
                           jnp.where(has_u, Gv - u, 0.0)) / bscale
        pri = jnp.max(jnp.maximum(viol, 0.0), axis=1)
        # r_p (Gv - t) folds into pri via t's interiority; check it too
        pri = jnp.maximum(pri, jnp.max(jnp.abs(Gv - t) / bscale, axis=1))
        dual = jnp.max(jnp.abs(r_d), axis=1)
        # every certified lane must meet ALL THREE bars — complementarity,
        # primal feasibility, AND stationarity. (An earlier strict-μ/pri
        # OR branch omitted the dual residual, so a lane whose μ collapsed
        # under asymmetric a_p/a_d steps could report converged with
        # stationarity unmet — a silently non-optimal "certified" control;
        # measured: a lane at μ=5e-11 / dual=3.5e-6 deviated 2.4e-3 from
        # the oracle, past the 1e-3 production bar. The step equalization
        # above now keeps r_d falling with μ, and eps_dual is the
        # deviation-calibrated stationarity bar — see IPMConfig.)
        conv = (mu < cfg.eps_mu * 10) & (pri < cfg.eps_feas * 10) \
            & (dual < jnp.asarray(cfg.eps_dual))

        x = x_p + v @ self.Zb.T
        return IPMSolution(z=x, converged=conv, mu=mu, pri_res=pri,
                           dual_res=dual, state=(v, t, zl, zu))

    # row-scaled UNREDUCED shared inequality rows (for the x_p offset)
    def _asGs(self):
        return jnp.asarray(self._Gs * self._es[:, None], self.dt)


#: tail profile for the hybrid pipeline (see HybridIPM): short f64 run
#: warm-started from the f32 entry state, with the interiorization pad
#: and neighborhood centering the transfer needs. Measured on the fov
#: flagship ensemble (64 lanes, seed 5): 63/64 converged, worst
#: converged-lane control deviation 3.7e-4 vs the exact oracle — same
#: certification quality as the cold 30-iteration f64 run at 1/3 the
#: f64 iteration work.
IPM_F64_TAIL = IPMConfig(iters=10, warm_pad=1e-6, warm_center_width=10.0)

#: PRODUCTION-calibrated tail (round 5, scripts/calibrate_tail{,2}.py on
#: the 2048-lane fov flagship ensemble vs a cold 40-iteration f64
#: reference): the default tail drives mu to ~1e-10 — far past the 1e-3
#: deviation contract — so its bars waste f64 iterations. Bars
#: (mu < 1e-8, dual < 1e-5) are the loosest with ZERO false
#: certifications at every tail length measured (8/10/12/14 iterations:
#: every accepted lane has deviation < 1e-3 or is e-equal-optimal;
#: looser bars (mu < 1e-6, dual < 1e-4) leak 0.2-0.5% false
#: certificates — measured, rejected). Acceptance on IMPC iter-1
#: problems: 8 it = 0.941, 10 it = 0.975, 12 it = 0.983, 14 it = 0.985.
#: 12 is the shipping point: the remaining ~1.5% of lanes are the
#: measured PIPELINE CEILING, not an iteration shortfall — their tail
#: runs genuinely stall (rejected-lane median deviation 0.55, relative
#: objective gaps to 1e2) and even the cold 40-iteration f64 reference
#: only converges 0.978 of this ensemble at strict bars. warm_mu_floor
#: stays 1e-4: dropping it to 1e-5 HALVED acceptance at every tail
#: length (the f32 state is genuinely off-path in its small coordinates;
#: re-centering shallower does not stick).
IPM_F64_TAIL_PROD = IPMConfig(iters=12, warm_pad=1e-6,
                              warm_center_width=10.0,
                              eps_mu=1e-9, eps_dual=1e-5)


@dataclasses.dataclass(frozen=True)
class HybridIPMConfig:
    """Configuration marker for the f32->f64 hybrid certified solver:
    StructuredIMPC builds a HybridIPM when given one of these.

    entry_only_first: run ONLY the f32 entry for IMPC iteration 0 and the
    full hybrid for iterations > 0 (the production-certified pipeline).
    Iteration 0's sole downstream role is seeding the predicted states
    that place iteration 1's CBF rows — the FLOWN curve is iteration 1's
    solution, and the per-QP certificate applies to that solve. Skipping
    iter-0's f64 tail erases ~45% of the pipeline's f64 work.
    """
    entry: IPMConfig = IPM_F32_ENTRY
    tail: IPMConfig = IPM_F64_TAIL
    entry_only_first: bool = False


#: the shipping certified configuration (see HybridIPMConfig and
#: IPM_F64_TAIL_PROD): f32-only IMPC iter 0, entry + calibrated 12-it f64
#: tail on iter 1.
HYBRID_PROD = HybridIPMConfig(tail=IPM_F64_TAIL_PROD, entry_only_first=True)


class HybridIPM:
    """f32 Mehrotra entry + short warm-started f64 tail.

    The certified-accuracy path at a fraction of the f64 cost: the f32
    IPM runs the bulk of the path-following on fast hardware arithmetic
    (mu to ~1e-5..1e-6, the f32 floor), its final interior state is
    re-interiorized and neighborhood-centered (IPMConfig.warm_*), and a
    short f64 run finishes to full certification. Same solve()
    interface and IPMSolution result as StructuredIPM; the reference
    comparison point is still CPLEX (qpcpp/src/solvers/CPLEX.cpp:35-178).

    MEASURED NEGATIVE RESULT (round 5, scripts/calibrate_tail.py): reusing
    the tail's interior state across IMPC iterations (solve iter-1 with
    state0 = iter-0's tail state, skipping the f32 entry) converges 0.1%
    of lanes at any tail length 5-10. The dynamic rows change IDENTITY
    between IMPC iterations (iter 0 activates only horizon step 0; iter 1
    re-places all rows at predicted states), so the transferred duals/
    slacks pair with different constraints and the warm start is
    adversarial, not helpful. Per-iteration fresh entries are the right
    structure; entry_only_first captures the real saving instead.
    """

    #: solutions whose `converged` flag is set meet the deviation-
    #: calibrated certificate (the f64 tail's bars) — see StructuredIMPC
    certifies = True

    def __init__(self, P: np.ndarray, A_s: np.ndarray, eq_mask_s: np.ndarray,
                 m_d: int, cfg: HybridIPMConfig = HybridIPMConfig()):
        self.cfg = cfg
        self.entry = StructuredIPM(P, A_s, eq_mask_s, m_d,
                                   dataclasses.replace(cfg.entry, dtype="f32"))
        self.tail = StructuredIPM(P, A_s, eq_mask_s, m_d,
                                  dataclasses.replace(cfg.tail, dtype="f64"))
        self.n, self.m_d = self.tail.n, m_d

    def solve(self, q, lb_s, ub_s, A_d, lb_d, ub_d,
              x0=None, ys0=None, yd0=None) -> IPMSolution:
        ent = self.entry.solve(q, lb_s, ub_s, A_d, lb_d, ub_d)
        return self.tail.solve(q, lb_s, ub_s, A_d, lb_d, ub_d,
                               state0=ent.state)
