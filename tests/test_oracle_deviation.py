"""Control deviation vs the native exact solver (the CPLEX stand-in).

BASELINE.json accuracy bar: max control deviation < 1e-3 vs the exact
solver at identical horizon. "Control" is what the robot actually flies:
the sampled accelerations U_basis @ z over the first replan period.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mpc_cbf_tpu.types import State
from mpc_cbf_tpu.ops.cbf import ConnectivityCBF, FovCBF
from mpc_cbf_tpu.ops.qp import ADMMConfig, solve_batch
from mpc_cbf_tpu.ops.qp.oracle import solve_oracle, solve_oracle_batch
from mpc_cbf_tpu.ops.qp.structured import StructuredConfig
from mpc_cbf_tpu.controllers import (
    BezierParams, MPCParams, BezierMPCOperator, IMPCParams,
    ConnectivityIMPCCBF, FovIMPCCBF,
)
from mpc_cbf_tpu.controllers.mpc_cbf import StructuredIMPC

MPC = MPCParams()


def test_oracle_basic():
    x, st, info = solve_oracle(2 * np.eye(2), np.zeros(2),
                               np.array([[1.0, 1.0]]), [1.0], [1e20])
    assert st == 0
    np.testing.assert_allclose(x, [0.5, 0.5], atol=1e-9)


def _flagship_qps(B, N=3, seed=0):
    """Assemble B feasible flagship MPC-CBF QPs (iteration-0 form)."""
    rng = np.random.default_rng(seed)
    op = BezierMPCOperator(BezierParams(), MPC, dim=3)
    cbf = ConnectivityCBF(1.0, 4.0, jnp.asarray(MPC.v_min), jnp.asarray(MPC.v_max))
    ctrl = ConnectivityIMPCCBF(op, cbf, IMPCParams(), N, solver=ADMMConfig(iters=400))

    pos = jnp.asarray(rng.normal(0, 0.3, (B, 3)))
    vel = jnp.asarray(rng.normal(0, 0.5, (B, 3)))
    goals = jnp.asarray(rng.normal(0, 3.0, (B, 3)))
    refs = jnp.tile(goals[:, None, :], (1, MPC.k_hor, 1)).reshape(B, -1)
    ang = rng.uniform(0, 2 * np.pi, (B, N))
    rad = rng.uniform(2.0, 4.5, (B, N))
    nbr_pos = np.stack([rad * np.cos(ang), rad * np.sin(ang), np.zeros_like(rad)], -1)
    nbr_vel = rng.normal(0, 0.5, (B, N, 3))
    blobs = jnp.asarray(np.concatenate([nbr_pos, nbr_vel], -1))
    mask = jnp.ones((B, N), bool)

    def build(p, v, r, nb, mk):
        x = jnp.concatenate([p, v])
        return ctrl.assemble(State(pos=p, vel=v), r, nb, mk,
                             jnp.broadcast_to(x, (2, 6)), jnp.arange(2) == 0)

    qp = jax.vmap(build)(pos, vel, refs, blobs, mask)
    return ctrl, op, qp, (pos, vel, refs, blobs, mask)


def _fov_flagship_qps(B, N=7, seed=3):
    """Assemble B FoV-FLAGSHIP MPC-CBF QPs (iteration-0 form): 8-robot
    team, 4 CBF families x cbf_horizon x 7 neighbors + 7x4 Voronoi rows +
    7 ranked slack columns — the reference's flagship configuration
    (``FovBezierIMPCCBF.cpp:47-223``), m_d = 84, n = 43."""
    rng = np.random.default_rng(seed)
    op = BezierMPCOperator(BezierParams(), MPC, dim=3)
    cbf = FovCBF(120.0 * np.pi / 180.0, 0.3, 6.0,
                 jnp.asarray(MPC.v_min), jnp.asarray(MPC.v_max))
    impc = IMPCParams(slack_mode=True)
    ctrl = FovIMPCCBF(op, cbf, impc, N,
                      box_half_extents=np.array([0.1, 0.1, 0.0]),
                      solver=ADMMConfig(iters=200))

    pos = jnp.asarray(rng.normal(0, 0.3, (B, 3)))
    vel = jnp.asarray(rng.normal(0, 0.5, (B, 3)))
    goals = jnp.asarray(rng.normal(0, 3.0, (B, 3)))
    refs = jnp.tile(goals[:, None, :], (1, MPC.k_hor, 1)).reshape(B, -1)
    ang = rng.uniform(0, 2 * np.pi, (B, N))
    rad = rng.uniform(1.0, 3.5, (B, N))
    cov = np.broadcast_to(np.array([0.05, 0.0, 0.05]), (B, N, 3))
    blobs = jnp.asarray(np.concatenate(
        [(rad * np.cos(ang))[..., None], (rad * np.sin(ang))[..., None],
         cov], axis=-1))
    mask = jnp.ones((B, N), bool)
    H = impc.cbf_horizon

    def build(p, v, r, nb, mk):
        x = jnp.concatenate([p, v])
        return ctrl.assemble(State(pos=p, vel=v), r, nb, mk,
                             jnp.broadcast_to(x, (H, 6)), jnp.arange(H) == 0)

    qp = jax.vmap(build)(pos, vel, refs, blobs, mask)
    return ctrl, op, qp, (pos, vel, refs, blobs, mask)


def test_fov_flagship_oracle_solves():
    """The exact oracle must handle the flagship QP family (slack costs at
    5e4 scale stalled the unnormalized Mehrotra IPM — objective scaling in
    native/qp_oracle.cpp fixed it)."""
    _, _, qp, _ = _fov_flagship_qps(8)
    x_ref, status = solve_oracle_batch(*(np.asarray(v) for v in
                                         (qp.P, qp.q, qp.A, qp.lb, qp.ub)))
    assert (status == 0).all(), status
    from mpc_cbf_tpu.types import BIG
    A, lb, ub = (np.asarray(v) for v in (qp.A, qp.lb, qp.ub))
    Ax = np.einsum("bmn,bn->bm", A, x_ref)
    bscale = np.maximum(1.0, np.maximum(
        np.where(lb > -BIG / 2, np.abs(lb), 0.0),
        np.where(ub < BIG / 2, np.abs(ub), 0.0)))
    viol = np.maximum((lb - Ax) / bscale, (Ax - ub) / bscale)
    assert viol.max() < 1e-9


def test_admm_control_deviation_vs_oracle():
    B = 8
    ctrl, op, qp, _ = _flagship_qps(B)
    # exact solutions from the native IPM
    x_ref, status = solve_oracle_batch(*(np.asarray(v) for v in
                                         (qp.P, qp.q, qp.A, qp.lb, qp.ub)))
    assert (status == 0).all(), status
    # batched solver (f64 here under conftest; the same code runs f32 on the GPU)
    sol = solve_batch(qp, ADMMConfig(iters=400))
    # controls actually flown: sampled accelerations over the horizon
    U = np.asarray(op.U_basis)
    u_ref = x_ref[:, :36] @ U.T
    u_admm = np.asarray(sol.z[:, :36]) @ U.T
    dev = np.abs(u_admm - u_ref).max()
    assert dev < 1e-3, f"control deviation vs oracle: {dev}"


def test_structured_control_deviation_vs_oracle():
    B = 8
    ctrl, op, qp, (pos, vel, refs, blobs, mask) = _flagship_qps(B)
    x_ref, status = solve_oracle_batch(*(np.asarray(v) for v in
                                         (qp.P, qp.q, qp.A, qp.lb, qp.ub)))
    assert (status == 0).all()

    simpc = StructuredIMPC(ctrl, StructuredConfig(iters=800))
    lb_s, ub_s = jax.vmap(ctrl.shared_bounds)(State(pos=pos, vel=vel))
    x_now = jnp.concatenate([pos, vel], -1)
    pred0 = jnp.broadcast_to(x_now[:, None, :], (B, 2, 6))
    active0 = jnp.arange(2) == 0
    A_d, lb_d, ub_d = jax.vmap(
        lambda p, v, nb, mk, pr: ctrl.dynamic_rows(State(pos=p, vel=v), nb, mk, pr, active0)
    )(pos, vel, blobs, mask, pred0)
    q = jax.vmap(op.linear_cost)(x_now, refs)
    sol = simpc.op_qp.solve(q, lb_s, ub_s, A_d, lb_d, ub_d)

    U = np.asarray(op.U_basis)
    u_ref = x_ref[:, :36] @ U.T
    u_st = np.asarray(sol.z[:, :36]) @ U.T
    dev = np.abs(u_st - u_ref).max()
    assert dev < 1e-3, f"structured control deviation vs oracle: {dev}"


def test_f32_production_deviation():
    """The RAW f32 ADMM floors at ~1e-1 worst-case control deviation (the
    flagship P spans 15 orders of magnitude; measured floor is
    iteration-independent from 200 to 1600 iters): f32 cannot pin down the
    optimum once the active set stops changing. The production path closes
    the gap with the f64 active-set polish — a fixed KKT re-solve with
    working-set updates from the f32 point (ops/qp/polish.py), which
    certifies <1e-3 (measured ~4e-7) on this exact seed: see
    tests/test_polish.py. This test pins the raw-f32 floor so a regression
    in the ADMM entry (which the polish depends on for its initial working
    set) is caught independently."""
    B = 8
    ctrl, op, qp, _ = _flagship_qps(B, seed=3)
    x_ref, status = solve_oracle_batch(*(np.asarray(v) for v in
                                         (qp.P, qp.q, qp.A, qp.lb, qp.ub)))
    assert (status == 0).all()
    qp32 = jax.tree.map(lambda a: a.astype(jnp.float32), qp)
    sol = solve_batch(qp32, ADMMConfig(iters=200))
    U = np.asarray(op.U_basis)
    dev = np.abs(np.asarray(sol.z[:, :36], np.float64) @ U.T - x_ref[:, :36] @ U.T).max()
    assert dev < 1.5e-1, f"f32 production deviation: {dev}"
