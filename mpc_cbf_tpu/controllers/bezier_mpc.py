"""Piecewise-Bézier MPC: static operator precompute + batched QP assembly.

Reference parity:
- operators:  ``mpc/src/optimization/PiecewiseBezierMPCQPOperations.cpp``
  (ctor :9-38, evalSamplingBasisMatrix :41-60, positionErrorPenaltyCost
  :62-91, controlEffortPenaltyCost :93-108)
- generator:  ``mpc/src/optimization/PiecewiseBezierMPCQPGenerator.cpp``
  (addEvalConstraint :167-180, addContinuityConstraint :182-229,
  addEvalBoundConstraints :148-165, addHyperplaneConstraintForPiece :229-…)
- controller: ``mpc/src/controller/BezierMPC.cpp:36-98``

Batch-first: every matrix that the reference assembles per-solve with Eigen is
either (a) static — precomputed once with float64 numpy and closed over as a
constant (quadratic cost, equality rows, bound rows, sampling bases), or
(b) a cheap batched contraction of the current state (linear cost, Voronoi
rows). The per-step work is a handful of matmuls + one batched QP solve.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from mpc_cbf_tpu.types import Array, QPBatch, BIG, State
from mpc_cbf_tpu.models.double_integrator import DoubleIntegrator
from mpc_cbf_tpu.ops.bernstein import PiecewiseBezier
from mpc_cbf_tpu.ops.geometry import voronoi_hyperplane, shift_hyperplane_for_box
from mpc_cbf_tpu.ops.qp import solve_batch, ADMMConfig


@dataclasses.dataclass(frozen=True)
class BezierParams:
    """bezier_params of base_config.json:66-71."""
    num_pieces: int = 3
    num_control_points: int = 4
    piece_max_parameter: float = 0.5
    continuity_degree: int = 3  # bezier_continuity_upto_degree


@dataclasses.dataclass(frozen=True)
class MPCParams:
    """mpc_params + physical_limits of base_config.json."""
    h: float = 0.1
    Ts: float = 0.01
    k_hor: int = 16
    w_pos_err: float = 10.0
    w_u_eff: float = 10.0
    spd_f: int = 8
    v_min: Tuple[float, ...] = (-2.0, -2.0, -2.6179938779914944)
    v_max: Tuple[float, ...] = (2.0, 2.0, 2.6179938779914944)
    a_min: Tuple[float, ...] = (-5.0, -5.0, -3.141592653589793)
    a_max: Tuple[float, ...] = (5.0, 5.0, 3.141592653589793)

    def validate(self, bezier: BezierParams):
        """Invariants of common/parsing.hpp:49-76 + config.md."""
        if self.Ts > self.h:
            raise ValueError("Ts must be <= h")
        if abs(self.h / self.Ts - round(self.h / self.Ts)) > 1e-9:
            raise ValueError("h must be an integer multiple of Ts")
        if self.spd_f > self.k_hor:
            raise ValueError("spd_f must be <= k_hor")
        horizon_span = (self.k_hor - 1) * self.h
        curve_span = bezier.num_pieces * bezier.piece_max_parameter
        if horizon_span > curve_span + 1e-9:
            raise ValueError(
                f"k_hor={self.k_hor} samples span {horizon_span}s beyond the "
                f"curve duration {curve_span}s")


class BezierMPCOperator:
    """Static operators for one (bezier_params, mpc_params, dim) config."""

    def __init__(self, bezier: BezierParams, mpc: MPCParams, dim: int = 3):
        mpc.validate(bezier)
        self.bezier, self.mpc, self.dim = bezier, mpc, dim
        self.pw = PiecewiseBezier(
            bezier.num_pieces, bezier.num_control_points, bezier.piece_max_parameter, dim
        )
        self.n_dec = self.pw.num_decision_variables
        model = DoubleIntegrator(dim=dim, ts=mpc.h)
        K = mpc.k_hor

        # h_samples = [0, h, ..., (K-1) h] (PiecewiseBezierMPCQPOperations.cpp:31-34)
        self.h_samples = np.linspace(0.0, (K - 1) * mpc.h, K)
        # U_basis: control points -> sampled accelerations  [dim*K, n_dec]
        self.U_basis = self.pw.eval_matrix(self.h_samples, 2)
        # position/velocity sampling of the curve itself
        self.pos_basis = self.pw.eval_matrix(self.h_samples, 0)
        self.vel_basis = self.pw.eval_matrix(self.h_samples, 1)

        A0_pos, _ = model.get_A0(K)
        L_pos, _ = model.get_lambda(K)
        self.A0_pos, self.Lambda_pos = A0_pos, L_pos

        # Q_pe: weight only the last spd_f steps
        # (positionErrorPenaltyCost, PiecewiseBezierMPCQPOperations.cpp:62-78)
        qdiag = np.zeros(dim * K)
        qdiag[dim * (K - mpc.spd_f):] = mpc.w_pos_err
        self.Qpe_diag = qdiag
        self.Phi = L_pos @ self.U_basis  # [dim*K, n_dec]

        # quadratic cost (z'Qz convention -> P = 2Q):
        #   pos-err quad: Phi' Qpe Phi
        #   effort: sum_{d=1..continuity} w_u_eff * Gram_d
        #   (BezierMPC.cpp:40-47 / FovBezierIMPCCBF.cpp:89-98)
        Q = self.Phi.T @ (qdiag[:, None] * self.Phi)
        for d in range(1, bezier.continuity_degree + 1):
            Q = Q + mpc.w_u_eff * self.pw.effort_gram(d)
        self.P_static = 2.0 * Q

        # equality rows: init pos/vel eval at t=0 (targets dynamic) +
        # continuity rows d=0..continuity-1 (targets 0)
        self.init_pos_rows = self.pw.piece_eval_row(0, 0.0, 0)  # [dim, n]
        self.init_vel_rows = self.pw.piece_eval_row(0, 0.0, 1)
        self.cont_rows = self.pw.continuity_rows(bezier.continuity_degree)

        # derivative bound rows at h_samples (addEvalBoundConstraints for
        # derivative degrees 2 then 1, FovBezierIMPCCBF.cpp:204-205)
        self.acc_rows = self.U_basis
        self.vel_rows = self.vel_basis

        # control-point selectors of piece 0 for hyperplane rows
        self.cp_rows_piece0 = self.pw.control_point_rows_for_piece(0)  # [P, dim, n]

        # curve sampling at the Ts grid for the sim step
        # (ts_samples, FovBezierIMPCCBF.cpp:36-40)
        u_interp = int(round(mpc.h / mpc.Ts))
        self.ts_samples = np.linspace(0.0, mpc.h - mpc.Ts, u_interp)

    # ----- cost -------------------------------------------------------------
    def linear_cost(self, x0: Array, ref_positions: Array) -> Array:
        """q from current state + reference positions [dim*K]
        (PiecewiseBezierMPCQPOperations.cpp:81-88). P is static."""
        A0 = jnp.asarray(self.A0_pos, x0.dtype)
        Phi = jnp.asarray(self.Phi, x0.dtype)
        w = jnp.asarray(self.Qpe_diag, x0.dtype)
        drift = A0 @ x0  # [dim*K]
        return 2.0 * ((drift - ref_positions) * w) @ Phi

    # ----- constraint blocks ------------------------------------------------
    def equality_rows(self, current: State):
        """(A, lb, ub) for init-state + continuity equalities."""
        dt = current.pos.dtype
        A = jnp.asarray(
            np.concatenate([self.init_pos_rows, self.init_vel_rows, self.cont_rows]), dt
        )
        target = jnp.concatenate([
            current.pos, current.vel, jnp.zeros(self.cont_rows.shape[0], dt)
        ])
        return A, target, target

    def bound_rows(self, dtype):
        """(A, lb, ub) for sampled accel + vel bounds."""
        K, dim = self.mpc.k_hor, self.dim
        A = jnp.asarray(np.concatenate([self.acc_rows, self.vel_rows]), dtype)
        a_min = jnp.tile(jnp.asarray(self.mpc.a_min, dtype), K)
        a_max = jnp.tile(jnp.asarray(self.mpc.a_max, dtype), K)
        v_min = jnp.tile(jnp.asarray(self.mpc.v_min, dtype), K)
        v_max = jnp.tile(jnp.asarray(self.mpc.v_max, dtype), K)
        return A, jnp.concatenate([a_min, v_min]), jnp.concatenate([a_max, v_max])

    def voronoi_rows(self, current_pos: Array, other_positions: Array,
                     other_mask: Array, box_half_extents: Array, epsilon: float = 1e-8):
        """Per-neighbor separating-hyperplane rows on piece-0 control points
        (FovBezierIMPCCBF.cpp:116-134; hyperplaneConstraintAll,
        BezierQPOperations.cpp:269-290). Yaw dimension zeroed as in the
        reference (current_xy(DIM-1)=0).

        other_positions [N, dim]; returns ([N*P, n_dec], lb, ub).
        """
        dt = current_pos.dtype
        self_xy = current_pos.at[..., -1].set(0.0)

        def one(other_pos, active):
            o_xy = other_pos.at[..., -1].set(0.0)
            normal, offset = voronoi_hyperplane(self_xy, o_xy)
            offset = shift_hyperplane_for_box(normal, offset, box_half_extents)
            # row per control point: normal . cp <= -offset - eps
            cp = jnp.asarray(self.cp_rows_piece0, dt)  # [P, dim, n]
            rows = jnp.einsum("d,pdn->pn", normal, cp)
            ub = jnp.full(rows.shape[0], -offset - epsilon, dt)
            rows = jnp.where(active, rows, 0.0)
            ub = jnp.where(active, ub, BIG)
            return rows, ub

        rows, ubs = jax.vmap(one)(other_positions, other_mask)
        m = rows.shape[0] * rows.shape[1]
        return (
            rows.reshape(m, self.n_dec),
            jnp.full(m, -BIG, dt),
            ubs.reshape(m),
        )

    def cbf_row_from_state_row(self, a: Array, b: Array, k: Array, dtype):
        """Lift an instantaneous CBF row (a . u_k + b >= 0) onto control
        points via the acceleration sampling basis:
        -(a . U_basis[k-block]) z <= b (FovMPCCBFQPOperations.cpp:28-41).

        k is the horizon step (static or traced int), a [dim], b scalar.
        """
        U = jnp.asarray(self.U_basis, dtype)  # [dim*K, n]
        blk = jax.lax.dynamic_slice_in_dim(U, k * self.dim, self.dim, axis=0)
        return -(a @ blk), b

    # ----- curve evaluation -------------------------------------------------
    def eval_solution(self, z: Array, ts: Sequence[float], derivative: int = 0) -> Array:
        E = jnp.asarray(self.pw.eval_matrix(list(ts), derivative), z.dtype)
        out = z @ E.T
        return out.reshape(*out.shape[:-1], len(ts), self.dim)


class BezierMPC:
    """Goal-reaching Bézier MPC without CBF (BezierMPC.cpp:36-98)."""

    def __init__(self, op: BezierMPCOperator, max_neighbors: int = 0,
                 box_half_extents=None, solver: ADMMConfig = ADMMConfig(iters=150)):
        self.op = op
        self.N = max_neighbors
        self.box = jnp.asarray(
            box_half_extents if box_half_extents is not None else np.zeros(op.dim)
        )
        self.solver = solver
        m = (
            2 * op.dim  # init
            + op.cont_rows.shape[0]
            + 2 * op.dim * op.mpc.k_hor  # acc+vel bounds
            + max_neighbors * op.bezier.num_control_points
        )
        self.m = m

    def assemble(self, current: State, ref_positions: Array,
                 other_positions: Optional[Array] = None,
                 other_mask: Optional[Array] = None) -> QPBatch:
        op = self.op
        dt = current.pos.dtype
        P = jnp.asarray(op.P_static, dt)
        q = op.linear_cost(current.stacked, ref_positions)

        A_eq, lb_eq, ub_eq = op.equality_rows(current)
        A_bd, lb_bd, ub_bd = op.bound_rows(dt)
        blocks = [(A_eq, lb_eq, ub_eq), (A_bd, lb_bd, ub_bd)]
        if self.N:
            blocks.append(
                op.voronoi_rows(current.pos, other_positions, other_mask, self.box.astype(dt))
            )
        A = jnp.concatenate([b[0] for b in blocks], axis=0)
        lb = jnp.concatenate([b[1] for b in blocks], axis=-1)
        ub = jnp.concatenate([b[2] for b in blocks], axis=-1)
        return QPBatch(P=P, q=q, A=A, lb=lb, ub=ub)

    def plan(self, current: State, ref_positions: Array,
             other_positions: Optional[Array] = None,
             other_mask: Optional[Array] = None,
             warm: Optional[Tuple[Array, Array]] = None):
        """Solve one MPC step; returns (coeffs [n_dec], solution)."""
        qp = self.assemble(current, ref_positions, other_positions, other_mask)
        x0, y0 = warm if warm is not None else (None, None)
        sol = solve_batch(qp, self.solver, x0=x0, y0=y0)
        return sol.z, sol
