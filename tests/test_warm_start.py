"""Warm-start plumbing of the structured ADMM path.

Round-4 change: StructuredSolution carries the shared/dynamic duals in
UNSCALED row coordinates; StructuredIMPC feeds them (plus the primal)
from IMPC iteration 0 into iteration 1, which then runs a reduced tail
budget (StructuredConfig.iters_tail); the sim rollout additionally
carries duals across replan steps and h-shifts the primal warm start.

The reference cold-starts CPLEX every solve (a fresh IloCplex model per
call, ``qpcpp/src/solvers/CPLEX.cpp:35-178``) — warm-starting across the
IMPC/replan structure is a capability of this rebuild only.
"""
import numpy as np
import jax
import jax.numpy as jnp

from mpc_cbf_tpu.types import State
from mpc_cbf_tpu.ops.qp.structured import StructuredConfig
from mpc_cbf_tpu.controllers.mpc_cbf import StructuredIMPC

from test_oracle_deviation import _fov_flagship_qps


def _fov_ensemble(B):
    ctrl, op, _qp, (pos, vel, refs, blobs, mask) = _fov_flagship_qps(B)
    f32 = jnp.float32
    pos, vel, refs, blobs = (jnp.asarray(a, f32) for a in (pos, vel, refs, blobs))
    return ctrl, op, State(pos=pos, vel=vel), refs, blobs, mask


def test_warm_tail_budget_matches_cold_full_budget():
    """Usable rate at warm 200+64 must be >= cold 200+200 (measured
    47/64 vs 46/64 on the full ensemble; this pins the smaller B=32
    slice). 'Cold' = round-3 behavior: duals re-zeroed at every solve."""
    B = 32
    ctrl, op, cur, refs, blobs, mask = _fov_ensemble(B)

    warm = StructuredIMPC(ctrl, StructuredConfig(iters=200, iters_tail=64))
    res_w = warm.optimize_batch(cur, refs, blobs, mask)

    cold = StructuredIMPC(ctrl, StructuredConfig(iters=200))
    orig = cold.op_qp.solve
    cold.op_qp.solve = lambda *a, ys0=None, yd0=None, **k: orig(*a, **k)
    res_c = cold.optimize_batch(cur, refs, blobs, mask)

    n_w = int(np.asarray(res_w.success).sum())
    n_c = int(np.asarray(res_c.success).sum())
    assert n_w >= n_c, (n_w, n_c)
    # and the warm result actually returns duals for the cross-step carry
    assert res_w.ys is not None and res_w.ys.shape == (B, warm.op_qp.m_s)
    assert res_w.yd is not None and res_w.yd.shape == (B, warm.op_qp.m_d)


def test_dual_warm_start_fixed_point():
    """Feeding a solve's (z, ys, yd) back as the warm start with a tiny
    iteration budget must stay at (close to) the same solution — the
    dual scale round-trip (unscaled <-> equilibrated coordinates) is the
    thing being checked; a wrong gamma/e factor would kick the iterate
    away in one step."""
    B = 8
    ctrl, op, cur, refs, blobs, mask = _fov_ensemble(B)
    simpc = StructuredIMPC(ctrl, StructuredConfig(iters=400))
    H = ctrl.impc.cbf_horizon
    x_now = cur.stacked
    pred0 = jnp.broadcast_to(x_now[:, None, :], (B, H, x_now.shape[-1]))
    active0 = jnp.arange(H) == 0
    A_d, lb_d, ub_d = jax.vmap(
        lambda p, v, nb, mk, pr: ctrl.dynamic_rows(
            State(pos=p, vel=v), nb, mk, pr, active0)
    )(cur.pos, cur.vel, blobs, mask, pred0)
    q = jnp.zeros((B, ctrl.n), jnp.float32)
    q = q.at[:, :op.n_dec].set(jax.vmap(op.linear_cost)(x_now, refs))
    lb_s, ub_s = jax.vmap(ctrl.shared_bounds)(cur)

    sol = simpc.op_qp.solve(q, lb_s, ub_s, A_d, lb_d, ub_d)
    resolved = simpc.op_qp.solve(q, lb_s, ub_s, A_d, lb_d, ub_d,
                                 x0=sol.z, ys0=sol.ys, yd0=sol.yd)
    drift = np.abs(np.asarray(resolved.z) - np.asarray(sol.z)).max()
    scale = max(1.0, float(np.abs(np.asarray(sol.z)).max()))
    assert drift / scale < 5e-2, drift
    # residual must not get WORSE than the converged entry by more than
    # the f32 noise floor
    assert float(jnp.max(resolved.pri_res)) <= float(jnp.max(sol.pri_res)) + 1e-2
