"""Iterative MPC-CBF controllers — the flagship (reference `mpc_cbf` lib).

Reference parity:
- FoV variant:          ``mpc_cbf/src/controller/FovBezierIMPCCBF.cpp:47-223``
- Connectivity variant: ``mpc_cbf/src/controller/ConnectivityIMPCCBF.cpp:47-215``
- constraint lifting:   ``mpc_cbf/src/optimization/FovMPCCBFQPOperations.cpp``
  (instantaneous CBF row applied at horizon step k through the acceleration
  sampling basis U_basis: A_row = -(a . U_basis[k]) with ub = b)
- slack plumbing:       ``mpc_cbf/src/optimization/MPCCBFQPGeneratorBase.cpp``

Iteration scheme (both variants):
  iter 0:   CBF rows evaluated at the *current* state, applied at step 0.
  iter > 0: previous iterate's curve sampled at h_samples[0..cbf_horizon)
            -> predicted states -> CBF rows applied at their step k.
  (impc_iter is static, so the loop unrolls into one jitted program.)

Fixed-shape design: the CBF block always has
``num_families * cbf_horizon * max_neighbors`` rows; at iter 0 only the
k = 0 rows are active and the rest are masked. One compiled program serves
every iteration/neighbor configuration, vmapped over agents and scenarios.

Slack weights are distance-ranked (nearest neighbor keeps the highest
violation price): w_i = slack_cost * decay^rank(i)
(ConnectivityIMPCCBF.cpp:74-101; the FoV controller's
``slack_weights[i] = w * decay^{idx[i]}`` at FovBezierIMPCCBF.cpp:76-81
applies the forward instead of inverse permutation — we implement the rank
semantics both variants intend).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from mpc_cbf_tpu.types import Array, QPBatch, BIG, State
from mpc_cbf_tpu.ops.cbf import FovCBF, ConnectivityCBF
from mpc_cbf_tpu.ops.geometry import distance_to_ellipse
from mpc_cbf_tpu.ops.qp import solve_batch, ADMMConfig
from mpc_cbf_tpu.controllers.bezier_mpc import BezierMPCOperator


@dataclasses.dataclass(frozen=True)
class IMPCParams:
    """cbf_params of base_config.json:55-63 (IMPCParams in the reference)."""
    cbf_horizon: int = 2
    impc_iter: int = 2
    slack_mode: bool = False
    slack_cost: float = 50000.0
    slack_decay_rate: float = 0.1


# CBF bound magnitudes are capped here: the alpha compositions (fifth power
# twice for FoV) reach 1e28 for distant neighbors, which float32 cannot carry
# through the solver. No achievable |a . U z| exceeds ~1e4, so any bound
# beyond the cap is equivalent to +inf (and a bound below -cap is still an
# infeasible row that trips the failure path).
CBF_BOUND_CAP = 1.0e6


class IMPCResult(NamedTuple):
    coeffs: Array          # [n_dec] control points of the curve to fly:
                           # the last USABLE iterate (converged or within
                           # USABLE_PRI_EPS of feasibility — what the
                           # reference caller flies as trajs.back(),
                           # MPCCBFFormationControl_example.cpp:160-163);
                           # if no iterate is usable, the final finite
                           # iterate — ADMM's minimal-violation compromise
                           # (max braking), strictly safer than the
                           # reference's fly-the-stale-curve fallback
    success: Array         # bool: at least one iterate was usable
    flyable: Array         # bool: coeffs hold SOME finite curve to fly
    all_converged: Array   # bool: every iteration strictly converged
    pri_res: Array         # worst primal residual across iterations
    iterates: Array        # [impc_iter, n_dec] per-iteration solutions
    # final ADMM duals (unscaled row coords; StructuredIMPC only, None on
    # the dense path) — feed back as warm_duals to the next replan step
    ys: Optional[Array] = None
    yd: Optional[Array] = None
    # [B] bool: the LAST iteration's solution (the curve flown whenever it
    # is usable) carries the <1e-3 deviation certificate — set only by
    # certifying solvers (f64 IPM / hybrid tail bars, active-set polish);
    # always False on raw-f32 paths (StructuredIMPC only, None on the
    # dense path)
    certified: Optional[Array] = None


def _rank_weights(distances: Array, w_init: float, decay: float) -> Array:
    """w[i] = w_init * decay^rank(i), nearest first."""
    order = jnp.argsort(distances)
    ranks = jnp.zeros_like(order).at[order].set(jnp.arange(order.shape[0]))
    # match the distances dtype: under x64 the Python-float arithmetic
    # promotes to f64, and scattering that into the f32 cost vector is a
    # dtype-promotion error in future JAX
    return (w_init * decay**ranks).astype(distances.dtype)


class _IMPCCBFBase:
    """Shared fixed-shape assembly for both IMPC-CBF variants."""

    #: an iterate is flyable even when the solver missed its convergence
    #: bars, as long as every constraint is violated by at most this much
    #: (CPLEX either proves optimality or returns nothing; a fixed-iteration
    #: ADMM instead returns a near-feasible compromise — on a genuinely
    #: infeasible iter>0 QP that compromise is a minimal-violation point,
    #: which is strictly safer to fly than the relaxed iter-0 curve the
    #: reference falls back to, ConnectivityIMPCCBF.cpp:203-211).
    #:
    #: QUANTIFIED (scripts/usable_eps_sweep.py: every baseline rotate
    #: instance x both controllers x eps in {0, 0.01, 0.05}, 60 steps):
    #: min pairwise separation never dropped below the CBF safety
    #: distance at ANY eps, and 0.05 strictly IMPROVED closed-loop
    #: outcomes on the fov flagship (6r: min_sep 1.20 -> 2.66 m, solver
    #: success 0.35 -> 1.00; 8r: success 0.00 -> 0.77) — near-feasible
    #: avoidance curves beat the eps=0 alternative of freezing on stale
    #: curves. Connectivity rollouts are eps-insensitive (identical
    #: trajectories at all three values). tests/test_usable_eps.py pins
    #: the separation property.
    USABLE_PRI_EPS: float = 0.05

    #: number of CBF constraint families per neighbor (4 for FoV, 1 for conn)
    num_families: int = 1
    #: continuity degrees: Fov uses d in [0, cont), connectivity [0, cont]
    continuity_inclusive: bool = False

    def __init__(self, op: BezierMPCOperator, impc: IMPCParams, max_neighbors: int,
                 solver: ADMMConfig = ADMMConfig(iters=150)):
        self.op = op
        self.impc = impc
        self.N = max_neighbors
        self.S = max_neighbors if impc.slack_mode else 0
        self.solver = solver
        self.n = op.n_dec + self.S

        upto = op.bezier.continuity_degree + (1 if self.continuity_inclusive else 0)
        self._cont_rows = op.pw.continuity_rows(upto)
        self.m_cbf = self.num_families * impc.cbf_horizon * max_neighbors

    # -- variant hooks -------------------------------------------------------
    def _cbf_rows_at(self, x: Array, neighbor_blob: Array):
        """Return (A [F,3], b [F]) instantaneous CBF rows for one neighbor at
        one state, F = num_families."""
        raise NotImplementedError

    def _neighbor_distance(self, current_pos: Array, neighbor_blob: Array) -> Array:
        raise NotImplementedError

    def _extra_rows(self, current: State, neighbor_blob: Array, neighbor_mask: Array,
                    pred_states: Array, active_k: Array):
        """Optional variant-specific rows (e.g. Voronoi hyperplanes, the
        λ₂-connectivity/CLF family); returns list of (A, lb, ub) over the
        full n columns or None. pred_states [H, 6] / active_k [H] carry
        the horizon context for Pred-variant rows."""
        return None

    # -- assembly ------------------------------------------------------------
    def _static_blocks(self, current: State):
        op, dt = self.op, current.pos.dtype
        A_eq = jnp.asarray(
            np.concatenate([op.init_pos_rows, op.init_vel_rows, self._cont_rows]), dt
        )
        t_eq = jnp.concatenate(
            [current.pos, current.vel, jnp.zeros(self._cont_rows.shape[0], dt)]
        )
        A_bd, lb_bd, ub_bd = op.bound_rows(dt)
        return (A_eq, t_eq, t_eq), (A_bd, lb_bd, ub_bd)

    def _cbf_block(self, pred_states: Array, neighbor_blob: Array,
                   neighbor_mask: Array, active_k: Array):
        """All CBF rows: pred_states [H, 6] (H = cbf_horizon), applied at
        step k; active_k [H] bool masks which horizon steps are in use.

        Returns (A [m_cbf, n_dec], ub [m_cbf], slack_idx [m_cbf]).
        """
        op = self.op
        H, F, N = self.impc.cbf_horizon, self.num_families, self.N
        dt = pred_states.dtype
        U = jnp.asarray(op.U_basis, dt)

        def rows_for(k, x_k, nbr):
            A_f, b_f = self._cbf_rows_at(x_k, nbr)  # [F,3],[F]
            blk = jax.lax.dynamic_slice_in_dim(U, k * op.dim, op.dim, axis=0)
            return -(A_f @ blk), b_f, jnp.sum(jnp.abs(A_f), axis=-1)

        # vmap over horizon steps and neighbors
        ks = jnp.arange(H)
        A_all, b_all, a_l1 = jax.vmap(
            lambda k, x_k: jax.vmap(lambda nbr: rows_for(k, x_k, nbr))(neighbor_blob)
        )(ks, pred_states)  # A: [H, N, F, n_dec], b: [H, N, F]

        mask = jnp.broadcast_to(
            active_k[:, None, None] & neighbor_mask[None, :, None], (H, N, F)
        )
        # Prune provably-inactive rows: the row constrains a . u_k with u_k
        # the sampled acceleration at step k, and the accel bound rows
        # already enforce |u_k|_inf <= a_max — so any b beyond
        # ||a||_1 * a_max can never bind. Far-neighbor alpha compositions
        # produce b ~ 1e4..1e28; leaving such rows "active" with huge
        # finite bounds destroys the f32 ADMM row scaling near
        # interactions (solver failures -> frozen robots).
        # reachable |u| under asymmetric bounds is max(|a_min|, |a_max|)
        # (matches FovCBFController's u_reach; using a_max alone could prune
        # a binding row when |a_min| > |a_max|)
        a_reach = float(max(np.max(np.abs(np.asarray(self.op.mpc.a_max))),
                            np.max(np.abs(np.asarray(self.op.mpc.a_min)))))
        mask = mask & (b_all <= a_l1 * a_reach)
        A_all = jnp.where(mask[..., None], A_all, 0.0)
        # Symmetric lower cap at the same reachability threshold: a row
        # with b < -|a|_1*a_reach is unsatisfiable by ANY control, so (on
        # slack-relaxed rows) it is tight at the optimum and its control
        # gradient is w*a regardless of how negative b is — capping at the
        # threshold (x2 margin) changes only the slack variable's value,
        # never the optimal control. Without the cap the alpha
        # compositions push b to -1e6..-1e28 (strongly violated FOV
        # barriers) and the slack columns must span 7 orders of magnitude
        # against the ~1e-1 trajectory variables, which floors the f32
        # solver near pri_res ~ 1 (unusable). On slack-less variants the
        # capped row is still infeasible, still tripping the failure path.
        b_all = jnp.maximum(b_all, -2.0 * a_l1 * a_reach)
        b_all = jnp.clip(b_all, -CBF_BOUND_CAP, CBF_BOUND_CAP)
        ub_all = jnp.where(mask, b_all, BIG)
        slack_idx = jnp.broadcast_to(jnp.arange(N)[None, :, None], (H, N, F))
        return (
            A_all.reshape(self.m_cbf, op.n_dec),
            ub_all.reshape(self.m_cbf),
            slack_idx.reshape(self.m_cbf),
            mask.reshape(self.m_cbf),
        )

    def _widen(self, A: Array, slack_idx: Optional[Array] = None,
               mask: Optional[Array] = None) -> Array:
        """Append slack columns (zero, or -1 at slack_idx where mask)."""
        dt = A.dtype
        if self.S == 0:
            return A
        if slack_idx is None:
            return jnp.concatenate([A, jnp.zeros((*A.shape[:-1], self.S), dt)], axis=-1)
        cols = -jax.nn.one_hot(slack_idx, self.S, dtype=dt)
        if mask is not None:
            cols = jnp.where(mask[..., None], cols, 0.0)
        return jnp.concatenate([A, cols], axis=-1)

    def assemble(self, current: State, ref_positions: Array, neighbor_blob: Array,
                 neighbor_mask: Array, pred_states: Array, active_k: Array) -> QPBatch:
        op, dt = self.op, current.pos.dtype
        n, S = self.n, self.S

        # cost
        P = jnp.zeros((n, n), dt).at[: op.n_dec, : op.n_dec].set(jnp.asarray(op.P_static, dt))
        q_dec = op.linear_cost(current.stacked, ref_positions)
        q = jnp.zeros(n, dt).at[: op.n_dec].set(q_dec)
        if S:
            dists = jax.vmap(lambda nb: self._neighbor_distance(current.pos, nb))(neighbor_blob)
            dists = jnp.where(neighbor_mask, dists, jnp.inf)
            q = q.at[op.n_dec :].set(_rank_weights(dists, self.impc.slack_cost,
                                                   self.impc.slack_decay_rate))

        (A_eq, lb_eq, ub_eq), (A_bd, lb_bd, ub_bd) = self._static_blocks(current)
        A_cbf, ub_cbf, slack_idx, cbf_mask = self._cbf_block(
            pred_states, neighbor_blob, neighbor_mask, active_k
        )

        blocks = [
            (self._widen(A_eq), lb_eq, ub_eq),
            (self._widen(A_bd), lb_bd, ub_bd),
            (self._widen(A_cbf, slack_idx, cbf_mask), jnp.full(self.m_cbf, -BIG, dt), ub_cbf),
        ]
        extra = self._extra_rows(current, neighbor_blob, neighbor_mask,
                                 pred_states, active_k)
        if extra:
            blocks.extend(extra)
        if S:
            eye_s = jnp.concatenate([jnp.zeros((S, op.n_dec), dt), jnp.eye(S, dtype=dt)], axis=-1)
            blocks.append((eye_s, jnp.zeros(S, dt), jnp.full(S, BIG, dt)))

        return QPBatch(
            P=P, q=q,
            A=jnp.concatenate([b[0] for b in blocks], axis=0),
            lb=jnp.concatenate([b[1] for b in blocks], axis=-1),
            ub=jnp.concatenate([b[2] for b in blocks], axis=-1),
        )

    # -- structured assembly -------------------------------------------------
    def static_parts(self):
        """(P [n,n], A_s [m_s,n], eq_mask [m_s]) — the blocks shared by every
        agent in a batch (coefficients only; targets are per-agent).

        Shared rows: init pos/vel eval (eq), continuity (eq), sampled
        accel/vel bounds, slack nonnegativity.
        """
        op, S, n = self.op, self.S, self.n
        P = np.zeros((n, n))
        P[: op.n_dec, : op.n_dec] = op.P_static
        rows = [
            np.concatenate([op.init_pos_rows, op.init_vel_rows, self._cont_rows]),
            np.concatenate([op.acc_rows, op.vel_rows]),
        ]
        eq_m = [np.ones(rows[0].shape[0], bool), np.zeros(rows[1].shape[0], bool)]
        A_s = np.concatenate(rows)
        A_s = np.concatenate([A_s, np.zeros((A_s.shape[0], S))], axis=1)
        if S:
            slack_rows = np.concatenate([np.zeros((S, op.n_dec)), np.eye(S)], axis=1)
            A_s = np.concatenate([A_s, slack_rows])
            eq_m.append(np.zeros(S, bool))
        return P, A_s, np.concatenate(eq_m)

    def shared_bounds(self, current: State):
        """(lb_s, ub_s) [m_s] for one agent (targets of the shared rows)."""
        op, S = self.op, self.S
        dt = current.pos.dtype
        t_eq = jnp.concatenate(
            [current.pos, current.vel, jnp.zeros(self._cont_rows.shape[0], dt)]
        )
        _, lb_bd, ub_bd = op.bound_rows(dt)
        lb = jnp.concatenate([t_eq, lb_bd])
        ub = jnp.concatenate([t_eq, ub_bd])
        if S:
            lb = jnp.concatenate([lb, jnp.zeros(S, dt)])
            ub = jnp.concatenate([ub, jnp.full(S, BIG, dt)])
        return lb, ub

    def dynamic_rows(self, current: State, neighbor_blob: Array, neighbor_mask: Array,
                     pred_states: Array, active_k: Array):
        """(A_d [m_d, n], lb_d, ub_d) for one agent: CBF rows (+ variant
        extras such as Voronoi), slack columns included."""
        dt = current.pos.dtype
        A_cbf, ub_cbf, slack_idx, cbf_mask = self._cbf_block(
            pred_states, neighbor_blob, neighbor_mask, active_k
        )
        A = self._widen(A_cbf, slack_idx, cbf_mask)
        lb = jnp.full(self.m_cbf, -BIG, dt)
        ub = ub_cbf
        extra = self._extra_rows(current, neighbor_blob, neighbor_mask,
                                 pred_states, active_k)
        if extra:
            for (Ae, lbe, ube) in extra:
                A = jnp.concatenate([A, Ae], axis=0)
                lb = jnp.concatenate([lb, lbe])
                ub = jnp.concatenate([ub, ube])
        return A, lb, ub

    #: extra dynamic rows beyond the CBF block (e.g. Voronoi); set by variants
    m_extra: int = 0

    @property
    def m_dynamic(self) -> int:
        return self.m_cbf + self.m_extra

    # -- the IMPC loop -------------------------------------------------------
    def optimize(self, current: State, ref_positions: Array, neighbor_blob: Array,
                 neighbor_mask: Array, warm: Optional[Array] = None) -> IMPCResult:
        """Run impc_iter assembly+solve rounds (FovBezierIMPCCBF.cpp:84-223).

        warm: optional [n] primal warm start (e.g. previous MPC step).
        """
        op, H = self.op, self.impc.cbf_horizon
        dt = current.pos.dtype
        h_samp = jnp.asarray(op.h_samples[:H], dt)
        pos_E = jnp.asarray(op.pw.eval_matrix(list(np.asarray(op.h_samples[:H])), 0), dt)
        vel_E = jnp.asarray(op.pw.eval_matrix(list(np.asarray(op.h_samples[:H])), 1), dt)

        # iteration 0: only step 0 active, pred state = current state
        x_now = jnp.concatenate([current.pos, current.vel])
        pred0 = jnp.broadcast_to(x_now, (H, 2 * op.dim))
        active0 = jnp.arange(H) == 0

        x0 = warm if warm is not None else jnp.zeros(self.n, dt)
        y0 = None
        coeffs = jnp.zeros(op.n_dec, dt)
        # the curve actually flown: the LAST CONVERGED iterate (the
        # reference appends a curve per successful solve and the caller
        # flies trajs.back(), MPCCBFFormationControl_example.cpp:160-163)
        best = jnp.zeros(op.n_dec, dt)
        any_ok = jnp.asarray(False)
        all_ok = jnp.asarray(True)
        worst = jnp.asarray(0.0, dt)
        iterates = []

        for it in range(self.impc.impc_iter):
            if it == 0:
                pred, active = pred0, active0
            else:
                pos = (pos_E @ coeffs).reshape(H, op.dim)
                vel = (vel_E @ coeffs).reshape(H, op.dim)
                pred = jnp.concatenate([pos, vel], axis=-1)
                active = jnp.ones(H, dtype=bool)
            qp = self.assemble(current, ref_positions, neighbor_blob, neighbor_mask,
                               pred, active)
            sol = solve_batch(qp, self.solver, x0=x0, y0=y0)
            coeffs = sol.z[: op.n_dec]
            x0, y0 = sol.z, sol.y
            finite = jnp.all(jnp.isfinite(sol.z))
            usable = sol.converged | ((sol.pri_res <= self.USABLE_PRI_EPS) & finite)
            best = jnp.where(usable, coeffs, best)
            any_ok = any_ok | usable
            all_ok = all_ok & sol.converged
            worst = jnp.maximum(worst, sol.pri_res)
            iterates.append(coeffs)

        last_finite = jnp.all(jnp.isfinite(coeffs))
        fly = jnp.where(any_ok, best, jnp.where(last_finite, coeffs, best))
        return IMPCResult(coeffs=fly, success=any_ok,
                          flyable=any_ok | last_finite, all_converged=all_ok,
                          pri_res=worst, iterates=jnp.stack(iterates))


class FovIMPCCBF(_IMPCCBFBase):
    """FoV variant: 4 families (safety, fov-lb, fov-rb, range) + Voronoi
    hyperplane rows on piece-0 control points.

    neighbor_blob per neighbor: [4] = [x, y, cov_xx=cov(0,0), cov_xy, cov_yy]
    — actually [5]; the covariance feeds the slack distance ranking only.
    """

    num_families = 4
    continuity_inclusive = False

    def __init__(self, op: BezierMPCOperator, cbf: FovCBF, impc: IMPCParams,
                 max_neighbors: int, box_half_extents=None,
                 solver: ADMMConfig = ADMMConfig(iters=150)):
        super().__init__(op, impc, max_neighbors, solver)
        self.cbf = cbf
        self.m_extra = max_neighbors * op.bezier.num_control_points
        self.box = jnp.asarray(
            box_half_extents if box_half_extents is not None else np.zeros(op.dim)
        )

    @staticmethod
    def pack_neighbors(positions_xy: Array, covs: Array) -> Array:
        """[N, 2] + [N, 2, 2] -> blob [N, 5]."""
        return jnp.concatenate(
            [positions_xy, covs[..., 0, 0:1], covs[..., 0, 1:2], covs[..., 1, 1:2]],
            axis=-1,
        )

    def _cbf_rows_at(self, x, nbr):
        t_xy = nbr[:2]
        a_s, b_s = self.cbf.safety_row(x, t_xy)
        a_l, b_l = self.cbf.lb_row(x, t_xy)
        a_r, b_r = self.cbf.rb_row(x, t_xy)
        a_g, b_g = self.cbf.range_row(x, t_xy)
        return jnp.stack([a_s, a_l, a_r, a_g]), jnp.stack([b_s, b_l, b_r, b_g])

    def _neighbor_distance(self, current_pos, nbr):
        cov = jnp.array([[nbr[2], nbr[3]], [nbr[3], nbr[4]]])
        return distance_to_ellipse(current_pos[:2], nbr[:2], cov)

    def _extra_rows(self, current, neighbor_blob, neighbor_mask,
                    pred_states, active_k):
        other_pos = jnp.concatenate(
            [neighbor_blob[:, :2], jnp.zeros((self.N, self.op.dim - 2),
                                             neighbor_blob.dtype)], axis=-1
        )
        A_v, lb_v, ub_v = self.op.voronoi_rows(
            current.pos, other_pos, neighbor_mask, self.box.astype(neighbor_blob.dtype)
        )
        return [(self._widen(A_v), lb_v, ub_v)]


class BezierMPCCBF(FovIMPCCBF):
    """Non-iterative single-shot MPC-CBF (reference
    ``mpc_cbf/src/controller/BezierMPCCBF.cpp:32-85``): one QP with the
    3 FoV CBF families (safety, fov-lb, fov-rb — no range row, :61-67)
    evaluated at the *current* state and applied at horizon step 0. No
    slack variables, no Voronoi rows (the reference stores a collision
    shape but never adds hyperplane constraints in optimize()).

    neighbor_blob per neighbor: [2] = target x, y.
    """

    num_families = 3
    continuity_inclusive = False

    def __init__(self, op: BezierMPCOperator, cbf: FovCBF, max_neighbors: int,
                 solver: ADMMConfig = ADMMConfig(iters=150)):
        impc = IMPCParams(cbf_horizon=1, impc_iter=1, slack_mode=False)
        super().__init__(op, cbf, impc, max_neighbors, solver=solver)
        self.m_extra = 0  # no Voronoi rows in the single-shot variant

    def _cbf_rows_at(self, x, nbr):
        t_xy = nbr[:2]
        a_s, b_s = self.cbf.safety_row(x, t_xy)
        a_l, b_l = self.cbf.lb_row(x, t_xy)
        a_r, b_r = self.cbf.rb_row(x, t_xy)
        return jnp.stack([a_s, a_l, a_r]), jnp.stack([b_s, b_l, b_r])

    def _neighbor_distance(self, current_pos, nbr):
        return jnp.linalg.norm(nbr[:2] - current_pos[:2])

    def _extra_rows(self, current, neighbor_blob, neighbor_mask,
                    pred_states, active_k):
        return None

    def derivative_control_inputs(self, coeffs: Array, derivative_degree: int) -> Array:
        """Sampled derivative at the Ts grid: U_basis(ts) @ coeffs
        (BezierMPCCBF.cpp:88-99). Returns [len(ts_samples)*dim]."""
        op = self.op
        E = jnp.asarray(
            op.pw.eval_matrix(list(np.asarray(op.ts_samples)), derivative_degree),
            coeffs.dtype,
        )
        return E @ coeffs


class ConnectivityIMPCCBF(_IMPCCBFBase):
    """Connectivity variant: pairwise safety CBF per neighbor
    (ConnectivityIMPCCBF.cpp:135-160; the lambda2/CLF block is present but
    disabled in the reference — see enable_connectivity flag), no Voronoi
    rows, continuity degrees 0..continuity (inclusive, :127-132).

    neighbor_blob per neighbor: full state [6].
    """

    num_families = 1
    continuity_inclusive = True

    #: λ₂ > threshold -> single connectivity CBF row, else pairwise CLF
    #: rows (ConnectivityControl.cpp:70-72; the MPC-level block at
    #: ConnectivityIMPCCBF.cpp:144-157 is commented out in the reference —
    #: enable_connectivity=True turns on the constraint family it intended)
    LAMBDA2_THRESHOLD = 0.1

    def __init__(self, op: BezierMPCOperator, cbf: ConnectivityCBF, impc: IMPCParams,
                 max_neighbors: int, solver: ADMMConfig = ADMMConfig(iters=150),
                 enable_connectivity: bool = False):
        super().__init__(op, impc, max_neighbors, solver)
        self.cbf = cbf
        self.enable_connectivity = enable_connectivity
        if enable_connectivity:
            # per horizon step: 1 λ₂ row + N CLF rows (exactly one family
            # active per step, branch-masked — fixed shapes)
            self.m_extra = impc.cbf_horizon * (1 + max_neighbors)

    def _cbf_rows_at(self, x, nbr):
        a, b = self.cbf.safety_row(x, nbr)
        return a[None], b[None]

    def _neighbor_distance(self, current_pos, nbr):
        return jnp.linalg.norm(nbr[:2] - current_pos[:2])

    def _extra_rows(self, current, neighbor_blob, neighbor_mask,
                    pred_states, active_k):
        """λ₂-connectivity / CLF rows lifted through U_basis
        (ConnectivityMPCCBFQPOperations.cpp:45-87 + the pred variants
        :112-171): λ₂, eigvec and h = λ₂ − ε come from the CURRENT team;
        per horizon step k the ego row of the team is replaced by the
        predicted state, rows are applied at step k via U_basis, and ub is
        b (connectivity) / −b (CLF). Exactly one family is active per step
        by the λ₂ branch. No slack coupling (the reference passes a
        constant slack_value = 0).

        DELIBERATE sign deviation: the reference's clfConstraint
        (``ConnectivityMPCCBFQPOperations.cpp:75-87``) emits −(a·u) ≤ −b,
        but V̈ + β₁V̇ + β₂V ≤ 0 requires +(a·u) ≤ −b — the form its OWN
        live CBF-only generator uses (``ConnectivityQPGenerator.cpp:47-55``).
        The MPC-level block is commented out in the reference and never
        ran; mirroring its sign drives robots AWAY from d_desired
        (measured: end positions ±14 m on a ±5 m-goal rollout). We emit
        the correct sign. Masked neighbors are deflated out of
        λ₂ (see ConnectivityCBF.lambda2) and their eigvec entries set to
        the ego's so their gradient terms vanish identically."""
        if not self.enable_connectivity:
            return None
        op, cbf = self.op, self.cbf
        H, N = self.impc.cbf_horizon, self.N
        dt = pred_states.dtype
        U = jnp.asarray(op.U_basis, dt)

        x_now = current.stacked
        team_now = jnp.concatenate([x_now[None], neighbor_blob])   # [N+1, 6]
        node_mask = jnp.concatenate([jnp.ones(1, bool), neighbor_mask])
        lam2, eigvec = cbf.lambda2(team_now[:, :2], node_mask)
        h_val = lam2 - cbf.epsilon
        use_conn = lam2 > self.LAMBDA2_THRESHOLD
        eigvec = jnp.where(node_mask, eigvec, eigvec[0])

        def rows_at(k, x_k):
            blk = jax.lax.dynamic_slice_in_dim(U, k * op.dim, op.dim, axis=0)
            team_k = team_now.at[0].set(x_k)
            a_c, b_c = cbf.conn_row(x_k, team_k, eigvec, h_val, 0)
            row_c = -(a_c @ blk)

            def clf(nbr):
                a, b = cbf.clf_row(x_k, nbr)
                return (a @ blk), -b

            A_clf, b_clf = jax.vmap(clf)(neighbor_blob)             # [N, n_dec]
            return row_c, b_c, A_clf, b_clf

        row_c, b_c, A_clf, b_clf = jax.vmap(rows_at)(jnp.arange(H), pred_states)
        conn_on = active_k & use_conn                               # [H]
        clf_on = (active_k & ~use_conn)[:, None] & neighbor_mask[None, :]
        b_c = jnp.clip(b_c, -CBF_BOUND_CAP, CBF_BOUND_CAP)
        b_clf = jnp.clip(b_clf, -CBF_BOUND_CAP, CBF_BOUND_CAP)
        A = jnp.concatenate([
            jnp.where(conn_on[:, None], row_c, 0.0),                # [H, n_dec]
            jnp.where(clf_on[..., None], A_clf, 0.0).reshape(H * N, -1),
        ])
        ub = jnp.concatenate([jnp.where(conn_on, b_c, BIG),
                              jnp.where(clf_on, b_clf, BIG).reshape(H * N)])
        lb = jnp.full(A.shape[0], -BIG, dt)
        return [(self._widen(A), lb, ub)]


class StructuredIMPC:
    """Batched IMPC-CBF driver over the structure-exploiting solver.

    Wraps a FovIMPCCBF / ConnectivityIMPCCBF and runs the whole agent (x
    scenario) batch through one StructuredQPOperator solve per IMPC
    iteration: the shared equality/bound blocks become batch-wide
    matmuls instead of per-agent GEMVs (see ops/qp/structured.py).
    """

    def __init__(self, ctrl: _IMPCCBFBase, cfg=None):
        """cfg: StructuredConfig (f32 ADMM, the throughput path — optionally
        +polish) or IPMConfig (f64 Mehrotra IPM, the certified-accuracy
        path replacing CPLEX, ops/qp/ipm.py)."""
        import dataclasses as _dc

        from mpc_cbf_tpu.ops.qp.structured import StructuredConfig, StructuredQPOperator
        from mpc_cbf_tpu.ops.qp.ipm import (
            HybridIPM, HybridIPMConfig, IPMConfig, StructuredIPM)

        self.ctrl = ctrl
        self.cfg = cfg if cfg is not None else StructuredConfig(iters=ctrl.solver.iters)
        P, A_s, eq_mask = ctrl.static_parts()
        self.op_qp_tail = None
        if isinstance(self.cfg, HybridIPMConfig):
            hyb = HybridIPM(P, A_s, eq_mask, ctrl.m_dynamic, self.cfg)
            if self.cfg.entry_only_first:
                # production-certified pipeline: iteration 0 runs ONLY the
                # f32 entry (it just seeds iter-1's predicted-state rows);
                # iterations > 0 run the full entry + f64 tail and carry
                # the certificate for the flown curve (HybridIPMConfig)
                self.op_qp = hyb.entry
                self.op_qp_tail = hyb
            else:
                self.op_qp = hyb
            return
        if isinstance(self.cfg, IPMConfig):
            self.op_qp = StructuredIPM(P, A_s, eq_mask, ctrl.m_dynamic, self.cfg)
            return
        q_hint = ctrl.impc.slack_cost if ctrl.impc.slack_mode else 0.0
        # slack nonnegativity rows sit LAST in A_s (static_parts); the
        # polish pre-pins them so its KKT solves stay bounded in the
        # zero-curvature slack coordinates. Each guard GROUP lists every
        # row touching slack j — its nonneg row plus its CBF rows (layout
        # [H, N, F] flattened, neighbor j owns rows (h*N + j)*F + f) — so
        # the polish can keep >= 1 of them pinned at all times.
        m_s = A_s.shape[0]
        guards, groups = (), ()
        if ctrl.S:
            H, F, N = ctrl.impc.cbf_horizon, ctrl.num_families, ctrl.N
            guards = tuple(range(m_s - ctrl.S, m_s))
            groups = tuple(
                (m_s - ctrl.S + j,) + tuple(
                    m_s + (h * N + j) * F + f
                    for h in range(H) for f in range(F))
                for j in range(ctrl.S))
        self.op_qp = StructuredQPOperator(P, A_s, eq_mask, ctrl.m_dynamic, self.cfg,
                                          q_scale_hint=q_hint,
                                          polish_guard_rows=guards,
                                          polish_guard_groups=groups)
        # warm solves (IMPC iterations > 0) enter with carried duals and a
        # near-solution primal, so they can run a reduced budget — a
        # second operator sharing the same problem family, built with the
        # tail iteration count (only small [n,n] constants duplicated)
        if self.cfg.iters_tail is not None and self.cfg.iters_tail != self.cfg.iters:
            self.op_qp_tail = StructuredQPOperator(
                P, A_s, eq_mask, ctrl.m_dynamic,
                _dc.replace(self.cfg, iters=self.cfg.iters_tail),
                q_scale_hint=q_hint, polish_guard_rows=guards,
                polish_guard_groups=groups)

    def _cost(self, current: State, ref_positions: Array,
              neighbor_blob: Array, neighbor_mask: Array) -> Array:
        """Per-lane linear cost q [B, n] (tracking + ranked slack weights)."""
        ctrl, op = self.ctrl, self.ctrl.op
        B = ref_positions.shape[0]
        q_dec = jax.vmap(op.linear_cost)(current.stacked, ref_positions)  # [B, n_dec]
        q = jnp.zeros((B, ctrl.n), current.pos.dtype).at[:, : op.n_dec].set(q_dec)
        if ctrl.S:
            def slack_w(cur_pos, blob, mask):
                d = jax.vmap(lambda nb: ctrl._neighbor_distance(cur_pos, nb))(blob)
                d = jnp.where(mask, d, jnp.inf)
                return _rank_weights(d, ctrl.impc.slack_cost, ctrl.impc.slack_decay_rate)
            q = q.at[:, op.n_dec:].set(
                jax.vmap(slack_w)(current.pos, neighbor_blob, neighbor_mask))
        return q

    def _rows(self, current: State, neighbor_blob: Array, neighbor_mask: Array,
              pred: Array, active: Array):
        """Per-lane dynamic rows (A_d [B, m_d, n], lb_d, ub_d)."""
        ctrl = self.ctrl
        return jax.vmap(
            lambda cur_p, cur_v, blob, mask, pr: ctrl.dynamic_rows(
                State(pos=cur_p, vel=cur_v), blob, mask, pr, active)
        )(current.pos, current.vel, neighbor_blob, neighbor_mask, pred)

    def _pred0(self, current: State):
        """IMPC iteration 0: the current state at every CBF horizon step,
        only step 0 active."""
        H = self.ctrl.impc.cbf_horizon
        x_now = current.stacked                                  # [B, 2*dim]
        pred0 = jnp.broadcast_to(x_now[:, None, :], (x_now.shape[0], H, x_now.shape[-1]))
        return pred0, jnp.arange(H) == 0

    def iteration0_problem(self, current: State, ref_positions: Array,
                           neighbor_blob: Array, neighbor_mask: Array):
        """The structured QP of IMPC iteration 0, as the solvers take it:
        (q, lb_s, ub_s, A_d, lb_d, ub_d); the shared blocks are
        ``self.ctrl.static_parts()``."""
        lb_s, ub_s = jax.vmap(self.ctrl.shared_bounds)(current)
        pred0, active0 = self._pred0(current)
        return (self._cost(current, ref_positions, neighbor_blob, neighbor_mask),
                lb_s, ub_s) + tuple(self._rows(current, neighbor_blob, neighbor_mask,
                                               pred0, active0))

    def optimize_batch(self, current: State, ref_positions: Array,
                       neighbor_blob: Array, neighbor_mask: Array,
                       warm: Optional[Array] = None,
                       warm_duals=None) -> IMPCResult:
        """Batched IMPC: current [B, ...] State, ref [B, dim*K],
        neighbor_blob [B, N, ...], neighbor_mask [B, N].

        warm: [B, n] primal warm start (e.g. the h-shifted previous
        curve). warm_duals: (ys [B, m_s], yd [B, m_d]) unscaled duals from
        the previous replan step's IMPCResult (ADMM path only)."""
        ctrl, op = self.ctrl, self.ctrl.op
        H = ctrl.impc.cbf_horizon
        dt = current.pos.dtype
        B = ref_positions.shape[0]
        pos_E = jnp.asarray(op.pw.eval_matrix(list(np.asarray(op.h_samples[:H])), 0), dt)
        vel_E = jnp.asarray(op.pw.eval_matrix(list(np.asarray(op.h_samples[:H])), 1), dt)

        q = self._cost(current, ref_positions, neighbor_blob, neighbor_mask)
        lb_s, ub_s = jax.vmap(ctrl.shared_bounds)(current)
        pred0, active0 = self._pred0(current)

        coeffs = jnp.zeros((B, op.n_dec), dt)
        best = jnp.zeros((B, op.n_dec), dt)
        x0 = warm if warm is not None else jnp.zeros((B, ctrl.n), dt)
        ys0, yd0 = warm_duals if warm_duals is not None else (None, None)
        any_ok = jnp.zeros(B, bool)
        all_ok = jnp.ones(B, bool)
        worst = jnp.zeros(B, dt)
        iterates = []

        for it in range(ctrl.impc.impc_iter):
            if it == 0:
                pred, active = pred0, active0
            else:
                pos = (coeffs @ pos_E.T.astype(coeffs.dtype)).reshape(B, H, op.dim)
                vel = (coeffs @ vel_E.T.astype(coeffs.dtype)).reshape(B, H, op.dim)
                pred = jnp.concatenate([pos, vel], axis=-1)
                active = jnp.ones(H, bool)
            A_d, lb_d, ub_d = self._rows(current, neighbor_blob, neighbor_mask,
                                         pred, active)
            # iterations > 0 enter warm (previous iterate's primal AND
            # duals) and may run the reduced tail budget
            op_solve = self.op_qp if (it == 0 or self.op_qp_tail is None) \
                else self.op_qp_tail
            if getattr(self.cfg, "polish", False):
                sol = op_solve.solve_polished(q, lb_s, ub_s, A_d, lb_d, ub_d,
                                              x0=x0, ys0=ys0, yd0=yd0)
            else:
                sol = op_solve.solve(q, lb_s, ub_s, A_d, lb_d, ub_d, x0=x0,
                                     ys0=ys0, yd0=yd0)
            # cast back to the caller's dtype: certifying solvers return
            # f64 under x64, but the sim/scan layer carries the input
            # dtype (the f32 round-off ~1e-7 is far below the 1e-3
            # certificate bar)
            coeffs = sol.z[:, : op.n_dec].astype(dt)
            x0 = sol.z
            ys0, yd0 = getattr(sol, "ys", None), getattr(sol, "yd", None)
            finite = jnp.all(jnp.isfinite(sol.z), axis=-1)
            usable = sol.converged | ((sol.pri_res <= ctrl.USABLE_PRI_EPS) & finite)
            best = jnp.where(usable[:, None], coeffs, best)
            any_ok = any_ok | usable
            all_ok = all_ok & sol.converged
            worst = jnp.maximum(worst, sol.pri_res)
            iterates.append(coeffs)

        last_finite = jnp.all(jnp.isfinite(coeffs), axis=-1)
        fly = jnp.where(any_ok[:, None], best,
                        jnp.where(last_finite[:, None], coeffs, best))
        # certificate of the flown curve: the LAST iteration's solution is
        # the flown one whenever usable, and only certifying solvers'
        # converged flag means <1e-3 deviation (see IMPCResult.certified)
        if hasattr(sol, "certified"):      # ADMM family: per-lane polish
            cert = sol.certified
        elif getattr(op_solve, "certifies", False):
            cert = sol.converged           # f64 IPM / hybrid calibrated bars
        else:
            cert = jnp.zeros(B, bool)
        return IMPCResult(coeffs=fly, success=any_ok,
                          flyable=any_ok | last_finite, all_converged=all_ok,
                          pri_res=worst, iterates=jnp.stack(iterates, axis=0),
                          ys=ys0, yd=yd0, certified=cert)
