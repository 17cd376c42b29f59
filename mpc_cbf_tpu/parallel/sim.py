"""Batched multi-agent simulation loops.

Replaces the reference's sequential per-robot sim mains
(``mpc_cbf/examples/connectivity/MPCCBFFormationControl_example.cpp:135-224``):
the `for robot` / `for iter` nest becomes one vmapped+jitted control step,
the outer sim loop a ``lax.scan``, scenarios an extra vmapped (and
mesh-sharded) leading axis.

Semantics note (SURVEY.md §7.6): the reference updates robots *sequentially*
within a timestep — robot i replans after robots j<i already moved. Here all
agents replan from the same snapshot (synchronized update), which is the
parallel-correct choice; trajectory parity with the reference is therefore
at the metric level, and per-QP parity at identical inputs.

Failure semantics (reference MPCCBFFormationControl_example.cpp:150-164):
on a failed solve the robot keeps flying its last successful curve — here a
``jnp.where`` on the per-agent success flag.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mpc_cbf_tpu.types import State, Array
from mpc_cbf_tpu.controllers.bezier_mpc import BezierMPCOperator
from mpc_cbf_tpu.controllers.mpc_cbf import _IMPCCBFBase, ConnectivityIMPCCBF, FovIMPCCBF
from mpc_cbf_tpu.ops.controls import add_random_noise
from mpc_cbf_tpu.parallel.mesh import SCENARIO_AXIS


class SimResult(NamedTuple):
    states: State            # final [.., A, dim] states
    traj_pos: Array          # [.., T, A, dim] positions at every replan step
    traj_vel: Array          # [.., T, A, dim]
    success: Array           # [.., T, A] per-step solver success
    coeffs: Array            # final curve coefficients [.., A, n_dec]
    # [.., T, A] bool: the step's flown curve carries the <1e-3 accuracy
    # certificate (certifying solvers only — all-False on raw paths and
    # the dense per-agent path; see IMPCResult.certified)
    certified: Optional[Array] = None


def _neighbor_blob_connectivity(states: State, i: Array, num_agents: int) -> Array:
    """All other agents' full states [A-1, 6] for agent i."""
    allx = jnp.concatenate([states.pos, states.vel], axis=-1)  # [A, 6]
    others = jnp.delete(jnp.arange(num_agents), i, assume_unique_indices=True)
    return allx[others]


def _neighbor_blob_fov(states: State, i: Array, num_agents: int, cov_diag: float) -> Array:
    """Other agents' [x, y, cov...] blobs with a fixed diagonal covariance
    (the simulation examples feed fixed estimates,
    BezierIMPCCBFPFXYYaw_example.cpp:196-203)."""
    others = jnp.delete(jnp.arange(num_agents), i, assume_unique_indices=True)
    xy = states.pos[others][:, :2]
    n = xy.shape[0]
    cov = jnp.broadcast_to(
        jnp.array([cov_diag, 0.0, cov_diag], xy.dtype), (n, 3)
    )
    return jnp.concatenate([xy, cov], axis=-1)


@dataclasses.dataclass(frozen=True)
class MultiAgentSim:
    """Closed-loop sim of one IMPC-CBF controller over A agents.

    controller: a FovIMPCCBF or ConnectivityIMPCCBF built for
    max_neighbors == num_agents - 1.
    """

    controller: _IMPCCBFBase
    num_agents: int
    noise_pos_std: float = 0.0
    noise_vel_std: float = 0.0
    fov_cov_diag: float = 0.01
    #: route the agent batch through the structure-exploiting solver
    #: (one batched solve for all agents) instead of vmapping
    #: the dense per-agent solver
    structured: bool = False
    #: solver configuration for the structured path: a StructuredConfig
    #: (f32 ADMM), IPMConfig (Mehrotra IPM — IPM_F32_ENTRY is the fov
    #: production profile: interior iterates are feasible by
    #: construction, usable rate 0.99 vs ADMM's 0.69), or HybridIPMConfig
    #: (certified). None = StructuredConfig(iters=controller.solver.iters).
    solver_cfg: object = None
    #: FoV mode: mask neighbors beyond this sensing radius out of the
    #: constraint set (None = the controller's Rs). The reference's
    #: estimator pipeline produces the same scoping physically — a target
    #: outside the FOV range never gets measurement updates
    #: (``pf_applications.cpp:8-45``; ``Geometry.cpp:60-74`` insideFOV
    #: includes the range test), so its rows are driven by stale priors,
    #: not true positions. Feeding TRUE far-teammate positions instead
    #: (the naive sim shortcut) activates Rs-range rows against robots up
    #: to 2x the sensing range away and drags the whole team inward —
    #: measured on a 10-robot radius-5 ring: every robot stalls ~1.7 m
    #: short of its goal with 99% solver convergence. Same rule as
    #: benchmarks/swarm.py's sensing mask. <= 0 disables.
    #:
    #: DELIBERATELY range-only: the reference's insideFOV
    #: (``Geometry.cpp:60-74``) also gates on the angular half-FOV, but an
    #: in-range out-of-cone target still gets constraint rows in the
    #: reference — fed by the estimator's (stale) prior, not dropped
    #: (``filter_node.cpp`` publishes an estimate per target regardless of
    #: visibility; the FOV-border CBF rows exist precisely to steer the
    #: cone TOWARD such targets, and masking them would delete the
    #: visibility-maintenance constraint family). Range-only scoping
    #: models "never measured, prior never initialized"; angular staleness
    #: is intentionally approximated by true positions (conservative —
    #: true position is the estimator's asymptote while the target was
    #: recently visible). Full estimator-in-the-loop behavior is available
    #: via CBFOnlySim(use_pf=True).
    sensing_radius: Optional[float] = None

    def _structured_impc(self):
        from mpc_cbf_tpu.controllers.mpc_cbf import StructuredIMPC
        from mpc_cbf_tpu.ops.qp.structured import StructuredConfig

        if not hasattr(self, "_simpc_cache"):
            cfg = self.solver_cfg if self.solver_cfg is not None \
                else StructuredConfig(iters=self.controller.solver.iters)
            object.__setattr__(self, "_simpc_cache",
                               StructuredIMPC(self.controller, cfg))
        return self._simpc_cache

    def _blobs(self, states: State) -> Array:
        ctrl, A = self.controller, self.num_agents
        if isinstance(ctrl, FovIMPCCBF):
            return jax.vmap(
                lambda i: _neighbor_blob_fov(states, i, A, self.fov_cov_diag)
            )(jnp.arange(A))
        return jax.vmap(
            lambda i: _neighbor_blob_connectivity(states, i, A)
        )(jnp.arange(A))

    def _neighbor_mask(self, states: State, blobs: Array) -> Array:
        """[A, A-1] sensing mask (see sensing_radius)."""
        A = self.num_agents
        if not isinstance(self.controller, FovIMPCCBF):
            return jnp.ones((A, A - 1), bool)
        rs = self.sensing_radius
        if rs is None:
            rs = float(self.controller.cbf.Rs)
        if rs <= 0:
            return jnp.ones((A, A - 1), bool)
        d = jnp.linalg.norm(states.pos[:, None, :2] - blobs[:, :, :2], axis=-1)
        return d <= rs

    def control_step(self, states: State, goals: Array,
                     warm: Optional[Array] = None, warm_duals=None,
                     return_duals: bool = False):
        """One replanning step for all agents from a common snapshot.

        states: [A, dim] State; goals: [A, dim]. Returns (coeffs [A, n],
        success [A], flyable [A]) — plus (ys, yd) when return_duals
        (structured path only; the duals warm-start the next replan step).
        """
        ctrl, op = self.controller, self.controller.op
        A = self.num_agents

        # goal yaw -> closest 2pi-equivalent of the current yaw, so the
        # reference trajectory never demands a long-way-around spin (the
        # FoV example layer does exactly this,
        # BezierIMPCCBFPFXYYaw_example.cpp:219-223 via convertToClosestYaw)
        from mpc_cbf_tpu.ops.geometry import convert_to_closest_yaw
        goals = goals.at[:, -1].set(
            convert_to_closest_yaw(states.pos[:, -1], goals[:, -1]))

        if self.structured:
            blobs = self._blobs(states)
            mask = self._neighbor_mask(states, blobs)
            ref = jnp.tile(goals, (1, op.mpc.k_hor))
            res = self._structured_impc().optimize_batch(
                states, ref, blobs, mask, warm=warm,
                warm_duals=warm_duals)
            if return_duals:
                # IPM-family solvers carry no ADMM duals (res.ys is None);
                # return None so the rollout carry keeps a uniform structure
                duals = (res.ys, res.yd) if res.ys is not None else None
                cert = res.certified if res.certified is not None \
                    else jnp.zeros_like(res.success)
                return res.coeffs, res.success, res.flyable, duals, cert
            return res.coeffs, res.success, res.flyable

        blobs_b = self._blobs(states)
        mask_b = self._neighbor_mask(states, blobs_b)

        def one(i, warm_i):
            ref = jnp.tile(goals[i], op.mpc.k_hor)
            cur = State(pos=states.pos[i], vel=states.vel[i])
            res = ctrl.optimize(cur, ref, blobs_b[i], mask_b[i], warm=warm_i)
            return res.coeffs, res.success, res.flyable

        warm_b = warm if warm is not None else jnp.zeros((A, ctrl.n), states.pos.dtype)
        coeffs, success, flyable = jax.vmap(one)(jnp.arange(A), warm_b)
        if return_duals:
            # dense path: no dual carry, no certification
            return coeffs, success, flyable, None, jnp.zeros_like(success)
        return coeffs, success, flyable

    def _shift_matrix(self) -> np.ndarray:
        """[n_dec, n_dec] linear map c -> coefficients of the least-squares
        fit (on the original piece grid) of the SAME curve advanced by h:
        curve'(t) ~ curve(min(t + h, T)). Used to h-shift the primal warm
        start across replan steps — after flying one period, the remaining
        optimal trajectory is approximately the previous one time-shifted,
        which is a far better solver entry than the unshifted coefficients
        (the standard MPC warm-start shift, impossible in the reference's
        cold-started CPLEX wrapper, CPLEX.cpp:35-178)."""
        op = self.controller.op
        T, h = float(op.pw.max_parameter), float(op.mpc.h)
        ts = np.linspace(0.0, T, 8 * op.bezier.num_pieces + 1)
        E = np.asarray(op.pw.eval_matrix(list(ts), 0))        # [M*dim, n]
        Esh = np.asarray(op.pw.eval_matrix(
            [min(t + h, T) for t in ts], 0))
        S, *_ = np.linalg.lstsq(E, Esh, rcond=None)
        return S

    def _age_eval_mats(self):
        """Eval operators for flying a curve its a-th period: row a maps
        control points -> state at t = min((a+1) h, max_parameter)
        (the reference clamps eval_t at the curve end,
        MPCCBFFormationControl_example.cpp:191-196)."""
        op = self.controller.op
        h = op.mpc.h
        n_ages = max(int(np.ceil(op.pw.max_parameter / h + 1e-9)), 1)
        ts = [min((a + 1) * h, op.pw.max_parameter) for a in range(n_ages)]
        E0 = np.stack([op.pw.eval_matrix([t], 0) for t in ts])  # [n_ages, dim, n]
        E1 = np.stack([op.pw.eval_matrix([t], 1) for t in ts])
        return E0, E1, n_ages

    def fly(self, coeffs: Array, prev: State, fresh: Array, key: Array,
            age: Optional[Array] = None, has_curve: Optional[Array] = None):
        """Advance each agent h seconds. Reference failure semantics
        (MPCCBFFormationControl_example.cpp:150-221): a fresh curve resets
        the eval clock; on a failed solve the agent KEEPS FLYING its last
        successful curve (eval time advancing, clamped at the curve end);
        only an agent that never had a curve holds with zero velocity.

        age: [A] int32, periods already flown on the current curve.
        has_curve: [A] bool. Returns (State, new_age, new_has_curve).
        """
        op = self.controller.op
        A = self.num_agents
        if age is None:
            age = jnp.zeros(A, jnp.int32)
        if has_curve is None:
            has_curve = jnp.zeros(A, bool)
        E0, E1, n_ages = self._age_eval_mats()
        dt = prev.pos.dtype
        E0 = jnp.asarray(E0, dt)
        E1 = jnp.asarray(E1, dt)

        idx = jnp.where(fresh, 0, jnp.minimum(age, n_ages - 1))
        has_curve_new = has_curve | fresh
        pos = jnp.einsum("adn,an->ad", E0[idx], coeffs)
        vel = jnp.einsum("adn,an->ad", E1[idx], coeffs)
        pos = jnp.where(has_curve_new[:, None], pos, prev.pos)
        vel = jnp.where(has_curve_new[:, None], vel, jnp.zeros_like(vel))
        st = State(pos=pos, vel=vel)
        if self.noise_pos_std > 0 or self.noise_vel_std > 0:
            st = add_random_noise(key, st, self.noise_pos_std, self.noise_vel_std)
        return st, idx + 1, has_curve_new

    @partial(jax.jit, static_argnames=("self", "num_steps"))
    def rollout(self, init: State, goals: Array, num_steps: int,
                key: Optional[Array] = None) -> SimResult:
        """scan the closed loop for num_steps replanning periods."""
        if key is None:
            key = jax.random.PRNGKey(0)
        n = self.controller.n
        A = self.num_agents
        dt = init.pos.dtype
        SHIFT = jnp.asarray(self._shift_matrix(), dt)
        # dual warm-start carry (structured path only): the previous
        # step's ADMM duals, h-unshifted (row identities are stable
        # across steps — same constraint families in the same slots)
        if self.structured and hasattr(self._structured_impc().op_qp, "m_s"):
            op_qp = self._structured_impc().op_qp
            duals0 = (jnp.zeros((A, op_qp.m_s), dt),
                      jnp.zeros((A, op_qp.m_d), dt))
        else:
            # dense path, or an IPM-family structured solver (no ADMM
            # dual carry — the IPM re-enters from its own cold start)
            duals0 = None

        def step(carry, k):
            states, warm, duals, cur_coeffs, age, has_curve = carry
            out = self.control_step(states, goals, warm, warm_duals=duals,
                                    return_duals=True)
            new_coeffs, success, fresh, new_duals, cert = out
            if new_duals is None:
                new_duals = duals
            # agents with no flyable result keep their previous curve
            # (reference keeps flying trajs.back(), see fly())
            cur_coeffs = jnp.where(fresh[:, None], new_coeffs, cur_coeffs)
            new_states, age, has_curve = self.fly(
                cur_coeffs, states, fresh, k, age, has_curve)
            # h-shifted primal warm start: next step replans from ~one
            # period into the current curve
            warm_new = jnp.zeros_like(warm).at[:, : cur_coeffs.shape[-1]].set(
                cur_coeffs @ SHIFT.T)
            return ((new_states, warm_new, new_duals, cur_coeffs, age, has_curve),
                    (new_states.pos, new_states.vel, success, cur_coeffs, cert))

        keys = jax.random.split(key, num_steps)
        warm0 = jnp.zeros((A, n), dt)
        carry0 = (init, warm0, duals0,
                  jnp.zeros((A, self.controller.op.n_dec), dt),
                  jnp.zeros(A, jnp.int32), jnp.zeros(A, bool))
        (final, *_), (tp, tv, succ, coeffs, cert) = jax.lax.scan(
            step, carry0, keys)
        return SimResult(states=final, traj_pos=tp, traj_vel=tv,
                         success=succ, coeffs=coeffs[-1], certified=cert)


def sharded_rollout(sim: MultiAgentSim, mesh: Mesh, init: State, goals: Array,
                    num_steps: int, keys: Optional[Array] = None) -> SimResult:
    """Scenario-sharded rollout: leading axis S of init/goals is sharded
    over the mesh's scenario axis; each scenario is an independent closed
    loop (near-linear scaling — the batched replacement for ScaleScript.sh).

    init: State with [S, A, dim] leaves; goals [S, A, dim].
    """
    S = goals.shape[0]
    if keys is None:
        keys = jax.random.split(jax.random.PRNGKey(0), S)
    sharding = NamedSharding(mesh, P(SCENARIO_AXIS))
    init = jax.tree.map(lambda x: jax.device_put(x, sharding), init)
    goals = jax.device_put(goals, sharding)
    keys = jax.device_put(keys, sharding)

    @jax.jit
    def run(init, goals, keys):
        return jax.vmap(lambda i, g, k: sim.rollout(i, g, num_steps, k))(init, goals, keys)

    return run(init, goals, keys)


# ---------------------------------------------------------------------------
# CBF-only closed loop (reference cbf/examples)
# ---------------------------------------------------------------------------


class CBFSimResult(NamedTuple):
    states: State      # final [.., A, dim]
    traj_pos: Array    # [.., T, A, dim]
    traj_vel: Array
    u: Array           # [.., T, A, 3] applied controls
    success: Array     # [.., T, A]
    est_mean: Array    # [.., T, A, N, 2] neighbor estimates (PF mode) or true xy
    est_cov: Array     # [.., T, A, N, 2, 2]


@dataclasses.dataclass(frozen=True)
class CBFOnlySim:
    """Closed loop of a single-step CBF-QP controller over A agents.

    Reference parity: the sim mains
    ``cbf/examples/connectivity/CBFFormationControl_example.cpp:18-160``
    (PID nominal -> ConnectivityControl QP -> applyInput) and
    ``cbf/examples/fov/CBFControl_example.cpp:145-230`` (per-neighbor
    particle filter with FOV negative-information update feeding
    FovControl). The per-robot loop is vmapped; the sim loop is a scan.

    controller: FovCBFController (per-neighbor xy+cov estimates) or
    ConnectivityCBFController (full team states). With ``use_pf`` (FoV
    only), per-(agent, neighbor) particle filters produce the estimates
    (PFApplications::processFovUpdate semantics); otherwise true neighbor
    positions with a fixed diagonal covariance are fed in, matching the
    fixed-estimate examples.
    """

    controller: object
    num_agents: int
    dt: float = 0.1                    # sim step (examples run at ts=0.1)
    spring_constant: float = 2.0       # nominal u = spring(goal) (Controls.h:17-27)
    fov_cov_diag: float = 0.04
    use_pf: bool = False
    pf_params: "PFParams | None" = None
    pf_process_std: float = 0.1
    pf_meas_std: float = 0.05

    def __post_init__(self):
        from mpc_cbf_tpu.models.double_integrator import DoubleIntegrator
        object.__setattr__(self, "_model", DoubleIntegrator(dim=3, ts=self.dt))

    @property
    def _is_fov(self) -> bool:
        from mpc_cbf_tpu.controllers.cbf_qp import FovCBFController
        return isinstance(self.controller, FovCBFController)

    def _nominal(self, states: State, goals: Array) -> Array:
        from mpc_cbf_tpu.ops.controls import critically_damped_spring_control
        from mpc_cbf_tpu.ops.geometry import convert_to_closest_yaw

        # never command a long-way-around yaw spin (convertToClosestYaw)
        goals = goals.at[:, -1].set(
            convert_to_closest_yaw(states.pos[:, -1], goals[:, -1]))
        return critically_damped_spring_control(states, goals, self.spring_constant)

    def control_step(self, states: State, goals: Array,
                     est_xy: Optional[Array] = None,
                     est_cov: Optional[Array] = None):
        """One CBF-QP step for all agents. est_xy/[A,N,2], est_cov [A,N,2,2]
        (FoV mode; defaults to true positions + fixed covariance).
        Returns (u [A,3], converged [A])."""
        ctrl, A = self.controller, self.num_agents
        u_des = self._nominal(states, goals)
        allx = jnp.concatenate([states.pos, states.vel], axis=-1)

        if self._is_fov:
            if est_xy is None:
                def blob(i):
                    others = jnp.delete(jnp.arange(A), i, assume_unique_indices=True)
                    return states.pos[others][:, :2]
                est_xy = jax.vmap(blob)(jnp.arange(A))
            if est_cov is None:
                est_cov = jnp.broadcast_to(
                    self.fov_cov_diag * jnp.eye(2, dtype=states.pos.dtype),
                    (A, A - 1, 2, 2),
                )

            def one(i, xy_i, cov_i):
                res = ctrl.control(allx[i], u_des[i], xy_i, cov_i,
                                   jnp.ones(A - 1, bool))
                return res.u, res.converged

            u, conv = jax.vmap(one)(jnp.arange(A), est_xy, est_cov)
        else:
            # team eigendecomposition hoisted out of the per-robot vmap
            le = ctrl.cbf.lambda2(allx[:, :2])

            def one(i):
                res = ctrl.control(allx, i, u_des[i], lam2_eigvec=le)
                return res.u, res.converged

            u, conv = jax.vmap(one)(jnp.arange(A))
        return u, conv

    def fly(self, states: State, u: Array, success: Array, key: Array,
            noise_pos_std: float = 0.0, noise_vel_std: float = 0.0) -> State:
        """Apply u through the double integrator; failed agents brake to
        zero velocity and hold (CBFFormationControl_example failure path)."""
        u = jnp.where(success[:, None], u, 0.0)
        nxt = self._model.step(states, u)
        nxt = State(pos=nxt.pos,
                    vel=jnp.where(success[:, None], nxt.vel, 0.0))
        if noise_pos_std > 0 or noise_vel_std > 0:
            nxt = add_random_noise(key, nxt, noise_pos_std, noise_vel_std)
        return nxt

    # -- PF estimator tick --------------------------------------------------
    def _pf_consts(self, dtype):
        from mpc_cbf_tpu.estimation.particle_filter import PFParams
        p = self.pf_params if self.pf_params is not None else PFParams(dt=self.dt)
        proc = self.pf_process_std * jnp.eye(2, dtype=dtype)
        meas = self.pf_meas_std**2 * jnp.eye(2, dtype=dtype)
        return p, proc, meas

    def pf_init_all(self, key: Array, states: State):
        """Per-(agent, neighbor) PF bank seeded at the true neighbor xy
        (filter_node.cpp:29-124 seeds at first estimate)."""
        from mpc_cbf_tpu.estimation.particle_filter import pf_init
        A = self.num_agents
        p, _, _ = self._pf_consts(states.pos.dtype)
        init_cov = 0.25 * jnp.eye(2, dtype=states.pos.dtype)

        def one(i, key_i):
            others = jnp.delete(jnp.arange(A), i, assume_unique_indices=True)
            keys = jax.random.split(key_i, A - 1)
            return jax.vmap(
                lambda k, x0: pf_init(k, x0, init_cov, p)
            )(keys, states.pos[others][:, :2])

        return jax.vmap(one)(jnp.arange(A), jax.random.split(key, A))

    def pf_step_all(self, key: Array, pf_bank, states: State):
        """One estimator tick for the whole bank; returns
        (new_bank, est_xy [A,N,2], est_cov [A,N,2,2])."""
        from mpc_cbf_tpu.estimation.particle_filter import process_fov_update
        A = self.num_agents
        p, proc, meas = self._pf_consts(states.pos.dtype)
        fov = self.controller.cbf.fov
        rs = self.controller.cbf.Rs

        def one(i, key_i, pf_i):
            others = jnp.delete(jnp.arange(A), i, assume_unique_indices=True)
            keys = jax.random.split(key_i, A - 1)
            return jax.vmap(
                lambda k, st_pf, nbr: process_fov_update(
                    k, st_pf, states.pos[i], nbr, proc, meas, fov, rs, p)
            )(keys, pf_i, states.pos[others][:, :2])

        new_bank, mean, cov = jax.vmap(one)(
            jnp.arange(A), jax.random.split(key, A), pf_bank)
        return new_bank, mean, cov

    @partial(jax.jit, static_argnames=("self", "num_steps"))
    def rollout(self, init: State, goals: Array, num_steps: int,
                key: Optional[Array] = None) -> CBFSimResult:
        if key is None:
            key = jax.random.PRNGKey(0)
        A = self.num_agents
        pf0 = None
        if self.use_pf:
            if not self._is_fov:
                raise ValueError("use_pf requires a FovCBFController")
            key, sub = jax.random.split(key)
            pf0 = self.pf_init_all(sub, init)

        def step(carry, k):
            states, pf = carry
            if self.use_pf:
                k_pf, k_fly = jax.random.split(k)
                pf, est_xy, est_cov = self.pf_step_all(k_pf, pf, states)
                u, conv = self.control_step(states, goals, est_xy, est_cov)
            else:
                k_fly = k
                u, conv = self.control_step(states, goals)
                if self._is_fov:
                    def blob(i):
                        others = jnp.delete(jnp.arange(A), i,
                                            assume_unique_indices=True)
                        return states.pos[others][:, :2]
                    est_xy = jax.vmap(blob)(jnp.arange(A))
                    est_cov = jnp.broadcast_to(
                        self.fov_cov_diag * jnp.eye(2, dtype=states.pos.dtype),
                        (A, A - 1, 2, 2))
                else:
                    est_xy = jnp.zeros((A, A - 1, 2), states.pos.dtype)
                    est_cov = jnp.zeros((A, A - 1, 2, 2), states.pos.dtype)
            nxt = self.fly(states, u, conv, k_fly)
            return (nxt, pf), (nxt.pos, nxt.vel, u, conv, est_xy, est_cov)

        keys = jax.random.split(key, num_steps)
        (final, _), (tp, tv, tu, conv, exy, ecov) = jax.lax.scan(
            step, (init, pf0), keys)
        return CBFSimResult(states=final, traj_pos=tp, traj_vel=tv, u=tu,
                            success=conv, est_mean=exy, est_cov=ecov)


# ---------------------------------------------------------------------------
# Bezier MPC (no CBF) closed loop (reference mpc/examples/BezierMPCXYYaw)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BezierMPCSim:
    """Closed loop of the CBF-free Bezier MPC with Voronoi separation
    (``mpc/examples/BezierMPCXYYaw_example.cpp``; controller
    ``mpc/src/controller/BezierMPC.cpp:36-98``). Same scan/vmap skeleton as
    MultiAgentSim."""

    controller: object            # BezierMPC built with max_neighbors=A-1
    num_agents: int
    noise_pos_std: float = 0.0
    noise_vel_std: float = 0.0

    def control_step(self, states: State, goals: Array,
                     warm: Optional[Array] = None):
        ctrl, A = self.controller, self.num_agents
        op = ctrl.op

        def one(i, warm_i):
            others = jnp.delete(jnp.arange(A), i, assume_unique_indices=True)
            ref = jnp.tile(goals[i], op.mpc.k_hor)
            cur = State(pos=states.pos[i], vel=states.vel[i])
            coeffs, sol = ctrl.plan(
                cur, ref, states.pos[others],
                jnp.ones(A - 1, bool) if A > 1 else jnp.zeros(0, bool),
                warm=(warm_i, None) if warm_i is not None else None,
            )
            return coeffs, sol.converged

        warm_b = warm if warm is not None else jnp.zeros(
            (A, op.n_dec), states.pos.dtype)
        return jax.vmap(one)(jnp.arange(A), warm_b)

    def fly(self, coeffs: Array, prev: State, success: Array, key: Array) -> State:
        op = self.controller.op
        t_end = float(op.ts_samples[-1] + op.mpc.Ts)
        pos = jax.vmap(lambda z: op.eval_solution(z, [t_end], 0)[0])(coeffs)
        vel = jax.vmap(lambda z: op.eval_solution(z, [t_end], 1)[0])(coeffs)
        pos = jnp.where(success[:, None], pos, prev.pos)
        vel = jnp.where(success[:, None], vel, jnp.zeros_like(vel))
        st = State(pos=pos, vel=vel)
        if self.noise_pos_std > 0 or self.noise_vel_std > 0:
            st = add_random_noise(key, st, self.noise_pos_std, self.noise_vel_std)
        return st

    @partial(jax.jit, static_argnames=("self", "num_steps"))
    def rollout(self, init: State, goals: Array, num_steps: int,
                key: Optional[Array] = None) -> SimResult:
        if key is None:
            key = jax.random.PRNGKey(0)
        n = self.controller.op.n_dec

        def step(carry, k):
            states, warm = carry
            coeffs, success = self.control_step(states, goals, warm)
            nxt = self.fly(coeffs, states, success, k)
            return (nxt, coeffs), (nxt.pos, nxt.vel, success, coeffs)

        keys = jax.random.split(key, num_steps)
        warm0 = jnp.zeros((self.num_agents, n), init.pos.dtype)
        (final, _), (tp, tv, succ, coeffs) = jax.lax.scan(step, (init, warm0), keys)
        return SimResult(states=final, traj_pos=tp, traj_vel=tv,
                         success=succ, coeffs=coeffs[-1])
