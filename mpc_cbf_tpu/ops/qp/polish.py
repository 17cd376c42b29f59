"""Mixed-precision active-set polish: f64 exactness on top of the f32 path.

The reference solves every QP exactly with CPLEX's active-set simplex
(``qpcpp/src/solvers/CPLEX.cpp:35-178``). The f32 structured ADMM
(ops/qp/structured.py) has a worst-case control
deviation floors near 1e-1 because f32 cannot RESOLVE THE ACTIVE SET on
~4% of binding rows (tests/test_oracle_deviation.py history). A single
f64 KKT solve against the f32-identified set inherits those
misidentifications — so this module iterates: a batched primal-dual
active-set refinement (OSQP's "solution polish", Stellato et al. 2020
§5.6, extended with working-set updates) entirely in float64:

  round:  pool   = top-k rows by (equality | active | proximity score)
          (x, y) = exact KKT solve with the pinned pool rows as equalities
          drop     pinned rows whose multiplier has the wrong sign
          add      rows the new x violates

Each round's KKT solve is exact in f64, so the working set self-corrects;
started from the near-optimal ADMM point this converges in a handful of
rounds (it is a semismooth-Newton/primal-dual active set step). All
shapes are static: the pool has a fixed width, rounds are a fixed-trip
``lax.scan``, and lanes that fail to certify (violation or stationarity
above tolerance) fall back to their ADMM iterate per lane.

Structure-aware: rows live in two blocks — A_s [m_s, n] shared across the
batch and A_d [B, m_d, n] per-lane (same split as ops/qp/structured.py) —
so the full [B, m, n] constraint tensor is never materialized; pool rows
are gathered from whichever block owns them.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from mpc_cbf_tpu.types import Array, BIG
from mpc_cbf_tpu.ops.qp.linsolve import plu_factor, plu_solve, spd_solve


@dataclasses.dataclass(frozen=True)
class PolishConfig:
    mass_rounds: int = 6     # bulk rederive-the-set rounds (fast, can zigzag)
    rounds: int = 10         # single-change cleanup rounds (drops first)
    pool_extra: int = 24     # pool width beyond the equality-row count
    sigma: float = 1e-9      # primal Tikhonov on the KKT (1,1) block
    # dual regularization on pinned rows. Must stay tiny: each pinned row
    # is violated by exactly delta*y_row*row_norm at the regularized
    # optimum (measured: 1e-11 puts ~2e-6 on high-norm continuity rows,
    # tripping certification); LU with partial pivoting + the IR pass
    # tolerates near-dependent working sets without more than this.
    delta: float = 1e-13
    act_tol: float = 1e-3    # initial near-active band (relative, f32 scale)
    viol_tol: float = 1e-9   # row enters the working set beyond this
    # wrong-sign multiplier threshold for drops, RELATIVE to the lane's
    # dual scale max(1, |q|_inf): multipliers scale with the cost gradient,
    # and the KKT solve's y noise floor sits near cond*eps of that scale —
    # an absolute 1e-9 threshold drops weakly-active rows on noise and
    # kicks near-converged lanes into infeasibility (measured)
    y_tol: float = 1e-7
    ok_viol: float = 1e-6    # certification: max relative violation
    ok_stat: float = 1e-6    # certification: relative stationarity residual
    chunk: int = 4096        # lanes per KKT solve (bounds f64 memory)


class PolishResult(NamedTuple):
    z: Array    # [B, n] polished primal (per-lane fallback to the input)
    ok: Array   # [B] bool: lane certified to f64 optimality
    viol: Array  # [B] max relative constraint violation of the output
    stat: Array  # [B] relative stationarity residual of the output


def _polish_chunk(P, A_s, q, lb_s, ub_s, A_d, lb_d, ub_d, x0, cfg: PolishConfig,
                  pool: int, guard_rows=(), guard_groups=()):
    """One chunk of lanes. All inputs already float64.

    P [n,n]; A_s [m_s,n]; q/x0 [B,n]; lb_s/ub_s [B,m_s]; A_d [B,m_d,n];
    lb_d/ub_d [B,m_d].
    """
    f64 = jnp.float64
    B, n = q.shape
    m_s, m_d = A_s.shape[0], A_d.shape[1]
    m = m_s + m_d

    lb = jnp.concatenate([lb_s, lb_d], axis=1)           # [B, m]
    ub = jnp.concatenate([ub_s, ub_d], axis=1)

    # row infinity norms (scale-aware tolerances)
    rn_s = jnp.max(jnp.abs(A_s), axis=1)                 # [m_s]
    rn_d = jnp.max(jnp.abs(A_d), axis=2)                 # [B, m_d]
    rn = jnp.concatenate([jnp.broadcast_to(rn_s, (B, m_s)), rn_d], axis=1)
    rn1 = jnp.maximum(rn, 1e-12)

    # bound scale per row: violations are judged relative to this. An
    # infinite (BIG) side must NOT inflate the scale — a one-sided row
    # would otherwise tolerate absolute violations of bscale*tol
    bscale = jnp.maximum(
        1.0, jnp.maximum(jnp.where(lb > -BIG / 2, jnp.abs(lb), 0.0),
                         jnp.where(ub < BIG / 2, jnp.abs(ub), 0.0)))
    eq = (ub - lb) <= 1e-9 * bscale                      # [B, m]
    masked = (lb <= -BIG / 2) & (ub >= BIG / 2)          # padding rows

    def matvec(x):                                       # [B,n] -> [B,m]
        Ax_s = x @ A_s.T
        Ax_d = jnp.einsum("bdj,bj->bd", A_d, x)
        return jnp.concatenate([Ax_s, Ax_d], axis=1)

    def gather_rows(idx):                                # [B,pool] -> [B,pool,n]
        if m_s == 0:
            return jnp.take_along_axis(A_d, idx[:, :, None], axis=1)
        shared = A_s[jnp.clip(idx, 0, m_s - 1)]
        if m_d:
            di = jnp.clip(idx - m_s, 0, m_d - 1)
            dyn = jnp.take_along_axis(
                A_d, di[:, :, None], axis=1)
            return jnp.where((idx < m_s)[:, :, None], shared, dyn)
        return shared

    take = lambda a, idx: jnp.take_along_axis(a, idx, axis=1)

    I_n = jnp.eye(n, dtype=f64)
    P_reg = P + cfg.sigma * I_n

    # initial working set from the f32 solution: violated or within the
    # f32 resolution band of a bound
    Ax0 = matvec(x0)
    d0 = jnp.minimum(Ax0 - lb, ub - Ax0)                 # [B, m]
    active0 = (~masked) & (~eq) & (d0 <= cfg.act_tol * bscale)
    # Guard rows (bound rows of zero-curvature slack columns) get
    # near-equality POOL priority so they are always pinnable: they are
    # the fallback covering row for their group (below). They are NOT
    # unconditionally pinned — pinning s=0 on a lane whose optimal slack
    # is ~1e3 wrecks even a perfect entry point (measured).
    gmask = jnp.zeros((m,), bool)
    if len(guard_rows):
        gmask = gmask.at[jnp.asarray(guard_rows)].set(True)
    guard_key = jnp.where(gmask[None, :] & ~masked & ~eq, 1e9, 0.0)  # [B, m]

    def ensure_cover(active_new, closeness):
        """Boundedness invariant: each zero-curvature (slack) column must
        keep >= 1 of its rows (guard_groups[g]) in the working set — at
        the optimum either its nonneg row (s=0) or one binding slack-
        coupled row (s>0) is active; a set violating this leaves the KKT
        (1,1) block singular in that column. For an uncovered group, add
        the group row closest to (or deepest past) its bound."""
        for g in guard_groups:
            in_g = jnp.zeros((m,), bool).at[jnp.asarray(g)].set(True)
            sel = in_g[None, :] & ~eq & ~masked
            covered = jnp.any(active_new & sel, axis=1)          # [B]
            cand = jnp.where(sel, closeness, -jnp.inf)
            best = jnp.argmax(cand, axis=1)                      # [B]
            hit = (row_ids[None, :] == best[:, None]) & ~covered[:, None]
            active_new = active_new | hit
        return active_new

    nk = n + pool
    row_ids = jnp.arange(m)
    qscale = jnp.maximum(jnp.max(jnp.abs(q), axis=1), 1.0)   # [B] dual scale
    y_drop = cfg.y_tol * qscale[:, None]

    def round_body(carry, _, mass: bool):
        x, active, side = carry
        # pool selection: equalities always, then current actives, then by
        # proximity/violation at the current point
        Ax = matvec(x)
        d = jnp.minimum(Ax - lb, ub - Ax) / bscale
        key = jnp.where(eq & ~masked, 1e12, 0.0) + guard_key \
            + jnp.where(active, 1e6, 0.0) \
            + jnp.where(masked, -1e18, -d)
        _, idx = jax.lax.top_k(key, pool)                # [B, pool]

        G = gather_rows(idx)                             # [B, pool, n]
        rn_g = take(rn1, idx)
        G = G / rn_g[:, :, None]                         # row-normalized
        eq_g = take(eq & ~masked, idx)
        act_g = take(active, idx)
        pin = eq_g | act_g                               # [B, pool]

        # Cap the PINNED set at n rows (the KKT stays square-solvable
        # only while the pinned rows can be independent; pinning more
        # than n turns the equality block into a delta-regularized
        # least-squares mush that thrashes the iteration — measured on
        # rough fov entries whose near-active band exceeds n - n_eq).
        # Priority: equalities, then each guard group's best covering
        # row, then actives by proximity.
        if guard_groups:
            cover_best = jnp.zeros((x.shape[0], m), bool)
            for g in guard_groups:
                in_g = jnp.zeros((m,), bool).at[jnp.asarray(g)].set(True)
                sel = in_g[None, :] & active & ~eq & ~masked
                cand = jnp.where(sel, -d, -jnp.inf)
                best = jnp.argmax(cand, axis=1)
                hit = (row_ids[None, :] == best[:, None]) \
                    & jnp.any(sel, axis=1)[:, None]
                cover_best = cover_best | hit
            cover_g = take(cover_best, idx)
        else:
            cover_g = jnp.zeros_like(eq_g)
        d_g = take(d, idx)
        rank_key = jnp.where(eq_g, jnp.inf,
                             jnp.where(act_g,
                                       jnp.where(cover_g, 1e9, 0.0) - d_g,
                                       -jnp.inf))
        cap = min(n, pool)
        _, keep_pos = jax.lax.top_k(rank_key, cap)       # [B, cap]
        keep = jnp.zeros_like(pin)
        keep = jax.vmap(lambda a, i: a.at[i].set(True))(keep, keep_pos)
        pin = pin & keep
        lb_g, ub_g = take(lb, idx), take(ub, idx)
        side_hi = take(side, idx)
        b_g = jnp.where(side_hi, ub_g, lb_g) / rn_g

        pinf = pin.astype(f64)
        Gp = G * pinf[:, :, None]
        K = jnp.zeros((x.shape[0], nk, nk), f64)
        K = K.at[:, :n, :n].set(P_reg)
        K = K.at[:, :n, n:].set(jnp.swapaxes(Gp, 1, 2))
        K = K.at[:, n:, :n].set(Gp)
        diag = -cfg.delta * pinf - (1.0 - pinf)
        K = K.at[:, n:, n:].set(jax.vmap(jnp.diag)(diag))
        rhs = jnp.concatenate([-q, pinf * b_g], axis=1)
        # the flagship P spans ~15 orders of magnitude; an unscaled LU
        # leaves ~1e-6 relative residual on the equality rows. Symmetric
        # Jacobi scaling plus one iterative-refinement pass recovers
        # ~1e-12.
        s = 1.0 / jnp.sqrt(jnp.maximum(jnp.max(jnp.abs(K), axis=2), 1e-12))
        Ks = s[:, :, None] * K * s[:, None, :]
        rs = s * rhs
        fac = plu_factor(Ks)
        sols = plu_solve(fac, rs)
        resid = rs - jnp.einsum("bij,bj->bi", Ks, sols)
        sols = sols + plu_solve(fac, resid)
        sol = s * sols
        x_new, y_g = sol[:, :n], sol[:, n:]

        # reject non-finite AND runaway solutions (an unbounded working
        # set drives pure-linear coordinates to ~q/sigma ~ 1e13); a
        # rejected lane keeps its point and set for this round
        xmag = jnp.max(jnp.abs(x), axis=1)
        fin = jnp.all(jnp.isfinite(x_new), axis=1) \
            & (jnp.max(jnp.abs(x_new), axis=1) <= 1e8 * jnp.maximum(1.0, xmag))
        x_new = jnp.where(fin[:, None], x_new, x)

        Axn = matvec(x_new)
        v_lo = (lb - Axn) / bscale                       # >0: lb violated
        v_hi = (Axn - ub) / bscale
        viol_amt = jnp.maximum(v_lo, v_hi)
        # KKT convention Px + q + G'y = 0: a row pinned at its UPPER bound
        # has y >= 0 at the optimum (y = lambda of a.x <= ub), a row pinned
        # at its LOWER bound has y <= 0 — same convention as the y_ls
        # certification check below
        wrongness = jnp.where(side_hi, y_g, -y_g)        # <0 => wrong sign
        wrongness = jnp.where(pin & ~eq_g & fin[:, None], wrongness, jnp.inf)

        if mass:
            # MASS phase: re-derive the whole working set each round —
            # keep right-signed pins, drop wrong-signed ones, add every
            # violated row. Converges in a couple of rounds from a good
            # entry; can zigzag on hard lanes (the single-change phase
            # below settles those).
            wrong = pin & ~eq_g & (wrongness < -y_drop)
            act_vals = pin & ~eq_g & ~wrong
            active_new = jnp.zeros_like(active)
            active_new = jax.vmap(lambda a, i, v: a.at[i].set(v))(
                active_new, idx, act_vals)
            viol_rows = (viol_amt > cfg.viol_tol) & ~eq & ~masked
            active_new = active_new | viol_rows
            # rejected lanes keep their working set untouched
            active_new = jnp.where(fin[:, None], active_new, active)
            active_new = ensure_cover(active_new, viol_amt)
            side_new = jnp.where(active_new & ~active, v_hi > v_lo, side)
        else:
            # SINGLE-change phase: one working-set change per lane per
            # round, DROPS FIRST (a wrongly-pinned row distorts the
            # subproblem and manufactures violations; with adds-first the
            # set only grows and never heals — measured). Then add the
            # most-violated row.
            drop_pos = jnp.argmin(wrongness, axis=1)     # pool position
            drop_any = jnp.take_along_axis(
                wrongness, drop_pos[:, None], axis=1)[:, 0] < -y_drop[:, 0]
            drop_row = jnp.take_along_axis(
                idx, drop_pos[:, None], axis=1)[:, 0]

            drop_any = drop_any & fin
            viol_sel = jnp.where(eq | masked | active, -jnp.inf, viol_amt)
            add_row = jnp.argmax(viol_sel, axis=1)       # [B]
            add_any = fin & (~drop_any) & (jnp.take_along_axis(
                viol_sel, add_row[:, None], axis=1)[:, 0] > cfg.viol_tol)
            add_side = jnp.take_along_axis(
                v_hi, add_row[:, None], axis=1)[:, 0] > 0.0

            hit_add = (row_ids[None, :] == add_row[:, None]) & add_any[:, None]
            hit_drop = (row_ids[None, :] == drop_row[:, None]) & drop_any[:, None]
            active_new = (active | hit_add) & ~hit_drop
            active_new = ensure_cover(active_new, viol_amt)
            side_new = jnp.where(active_new & ~active,
                                 jnp.where(hit_add, add_side[:, None],
                                           v_hi > v_lo), side)
        return (x_new, active_new, side_new), None

    # initial pin side: nearer bound at the entry point
    side0 = (ub - Ax0) < (Ax0 - lb)
    active0 = ensure_cover(active0, jnp.maximum(lb - Ax0, Ax0 - ub) / bscale)
    carry = (x0, active0, side0)
    if cfg.mass_rounds:
        carry, _ = jax.lax.scan(partial(round_body, mass=True), carry,
                                None, length=cfg.mass_rounds)
    (x_fin, active_fin, _), _ = jax.lax.scan(
        partial(round_body, mass=False), carry, None, length=cfg.rounds)

    # certification: recompute multipliers for the final set once more and
    # measure violation + stationarity of the final point
    Ax = matvec(x_fin)
    d = jnp.minimum(Ax - lb, ub - Ax) / bscale
    viol = jnp.max(jnp.where(masked, 0.0, jnp.maximum(-d, 0.0)), axis=1)

    key = jnp.where(eq & ~masked, 1e12, 0.0) + guard_key \
        + jnp.where(active_fin, 1e6, 0.0) \
        + jnp.where(masked, -1e18, -d)
    _, idx = jax.lax.top_k(key, pool)
    G = gather_rows(idx) / take(rn1, idx)[:, :, None]
    pin = take((eq | active_fin) & ~masked, idx)
    # least-squares multipliers on the pinned rows:
    #   min_y || P x + q + G' y ||  restricted to pinned columns
    r0 = jnp.einsum("ij,bj->bi", P, x_fin) + q           # [B, n]
    Gp = G * pin[:, :, None].astype(f64)
    GG = jnp.einsum("bpj,bqj->bpq", Gp, Gp)
    gy = -jnp.einsum("bpj,bj->bp", Gp, r0)
    # GG is SPD(+jitter): Cholesky
    y_ls = spd_solve(GG, gy, jitter=1e-12)
    stat_vec = r0 + jnp.einsum("bpj,bp->bj", Gp, y_ls)
    stat = jnp.max(jnp.abs(stat_vec), axis=1) / qscale

    # dual-sign check: a feasible stationary point with a wrong-sign
    # multiplier on an inequality is NOT optimal (it is the optimum of the
    # wrong working set) — reject such lanes
    Ax_g = take(Ax, idx)
    side_fin = (take(ub, idx) - Ax_g) < (Ax_g - take(lb, idx))
    ineq_pin = pin & ~take(eq, idx)
    sign_bad = jnp.any(
        ineq_pin & jnp.where(side_fin, y_ls < -1e-6 * qscale[:, None],
                             y_ls > 1e-6 * qscale[:, None]), axis=1)

    ok = (viol <= cfg.ok_viol) & (stat <= cfg.ok_stat) & ~sign_bad \
        & jnp.all(jnp.isfinite(x_fin), axis=1)
    z = jnp.where(ok[:, None], x_fin, x0)
    return PolishResult(z=z, ok=ok, viol=viol, stat=stat)


@partial(jax.jit, static_argnames=("cfg", "pool", "guard_rows", "guard_groups"))
def _polish_jit(P, A_s, q, lb_s, ub_s, A_d, lb_d, ub_d, x0, cfg, pool,
                guard_rows=(), guard_groups=()):
    B = q.shape[0]
    chunk = min(cfg.chunk, B)
    if B % chunk != 0:
        chunk = B  # irregular batch: single chunk
    if chunk == B:
        return _polish_chunk(P, A_s, q, lb_s, ub_s, A_d, lb_d, ub_d, x0,
                             cfg, pool, guard_rows, guard_groups)
    resh = lambda a: a.reshape((B // chunk, chunk) + a.shape[1:])
    out = jax.lax.map(
        lambda t: _polish_chunk(P, A_s, t[0], t[1], t[2], t[3], t[4], t[5],
                                t[6], cfg, pool, guard_rows, guard_groups),
        (resh(q), resh(lb_s), resh(ub_s), resh(A_d), resh(lb_d), resh(ub_d),
         resh(x0)))
    flat = lambda a: a.reshape((B,) + a.shape[2:])
    return PolishResult(*(flat(a) for a in out))


def polish_structured(P, A_s, q, lb_s, ub_s, A_d, lb_d, ub_d, x0,
                      cfg: PolishConfig = PolishConfig(),
                      max_eq: Optional[int] = None,
                      guard_rows=(), guard_groups=()) -> PolishResult:
    """Polish a batch of structured QPs (shared A_s + per-lane A_d) in f64.

    P [n,n] and A_s [m_s,n] shared; q/x0 [B,n]; lb_s/ub_s [B,m_s];
    A_d [B,m_d,n]; lb_d/ub_d [B,m_d]. Inputs may be f32 (the production
    entry path); everything is upcast here. Requires jax_enable_x64.

    guard_rows: global row indices (shared rows first, then dynamic) whose
    bound should start PINNED in every lane — pass the nonnegativity rows
    of zero-curvature slack columns so the working-set KKT solves stay
    bounded (see _polish_chunk).
    guard_groups: tuple of tuples of global row indices; each group lists
    ALL rows touching one zero-curvature column, and the working set is
    forced to keep >= 1 row per group every round (boundedness invariant;
    see _polish_chunk.ensure_cover).
    """
    if not jax.config.jax_enable_x64:
        raise RuntimeError(
            "active-set polish requires jax_enable_x64 (f64 KKT solves)")
    f64 = jnp.float64
    to64 = lambda a: jnp.asarray(a, f64)
    m_s = A_s.shape[0]
    if max_eq is None:
        # worst-case equality count from the shared bounds of lane 0 —
        # callers with exact knowledge should pass max_eq
        max_eq = m_s
    # guard rows enter the pool at priority 1e9 (above actives) — widen
    # the pool by their count so they never displace pinnable slots on
    # slack-heavy lanes with many near-active rows
    pool = min(max_eq + len(guard_rows) + cfg.pool_extra,
               m_s + A_d.shape[1])
    return _polish_jit(to64(P), to64(A_s), to64(q), to64(lb_s), to64(ub_s),
                       to64(A_d), to64(lb_d), to64(ub_d), to64(x0), cfg, pool,
                       tuple(int(i) for i in guard_rows),
                       tuple(tuple(int(i) for i in g) for g in guard_groups))


def polish_dense(qp, x0, cfg: PolishConfig = PolishConfig(),
                 max_eq: Optional[int] = None) -> PolishResult:
    """Polish a dense QPBatch (per-lane P not supported: P must be shared
    across the batch, which holds for every controller in this package —
    only q / A / bounds vary per lane)."""
    P = qp.P
    if P.ndim == 3:
        P = P[0]
    A = qp.A
    B = qp.q.shape[0]
    A_s = jnp.zeros((0, qp.q.shape[-1]), A.dtype)
    lb_s = jnp.zeros((B, 0), qp.lb.dtype)
    ub_s = jnp.zeros((B, 0), qp.ub.dtype)
    if max_eq is None:
        import numpy as _np
        # same RELATIVE equality test as _polish_chunk (ub-lb vs bound
        # scale): an absolute test would undercount large-magnitude
        # equality rows and leave the pool too narrow to pin them all
        _lb, _ub = _np.asarray(qp.lb), _np.asarray(qp.ub)
        _bscale = _np.maximum(
            1.0, _np.maximum(_np.where(_lb > -BIG / 2, _np.abs(_lb), 0.0),
                             _np.where(_ub < BIG / 2, _np.abs(_ub), 0.0)))
        max_eq = int(_np.max(_np.sum((_ub - _lb) <= 1e-9 * _bscale, axis=-1)))
    cfgp = cfg
    pool = min(max_eq + cfg.pool_extra, qp.m)
    f64 = jnp.float64
    to64 = lambda a: jnp.asarray(a, f64)
    return _polish_jit(to64(P), to64(A_s), to64(qp.q), lb_s.astype(f64),
                       ub_s.astype(f64), to64(A), to64(qp.lb), to64(qp.ub),
                       to64(x0), cfgp, pool)
