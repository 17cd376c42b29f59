"""Batched Mehrotra IPM (ops/qp/ipm.py) vs the native exact oracle.

This is the CERTIFIED fov-flagship accuracy path: the f32 ADMM entry +
active-set polish certifies the connectivity variant (test_polish.py) but
cannot reach the bar on slack-saturated fov lanes; the f64 IPM solves the
same QPs to ~1e-8 control deviation from a cold start.

Oracle: native/qp_oracle.cpp (Mehrotra IPM, Eigen, f64) — the stand-in
for the reference's CPLEX (``qpcpp/src/solvers/CPLEX.cpp:35-178``).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mpc_cbf_tpu.ops.qp.ipm import IPMConfig, StructuredIPM
from mpc_cbf_tpu.ops.qp.oracle import solve_oracle_batch
from mpc_cbf_tpu.types import BIG

from test_oracle_deviation import _flagship_qps, _fov_flagship_qps


def _split_structured(ctrl, qp):
    """Recover (q, lb_s, ub_s, A_d, lb_d, ub_d) from the dense QPBatch:
    assemble() emits [eq | bounds | CBF | extra | slack] rows while
    static_parts() orders shared rows [eq | bounds | slack] — so the
    shared bounds are rows [:m_eq+m_bd] + the trailing slack rows, and the
    dynamic block is the middle."""
    P, A_s, eq_mask = ctrl.static_parts()
    m_s, m_d, S = A_s.shape[0], ctrl.m_dynamic, ctrl.S
    m_head = m_s - S
    lb, ub = np.asarray(qp.lb), np.asarray(qp.ub)
    A = np.asarray(qp.A)
    lb_s = np.concatenate([lb[:, :m_head], lb[:, m_head + m_d:]], axis=1)
    ub_s = np.concatenate([ub[:, :m_head], ub[:, m_head + m_d:]], axis=1)
    A_d = A[:, m_head:m_head + m_d]
    lb_d = lb[:, m_head:m_head + m_d]
    ub_d = ub[:, m_head:m_head + m_d]
    # sanity: the dense rows must match the static parts
    np.testing.assert_allclose(A[0, :m_head], A_s[:m_head], atol=0)
    return (P, A_s, eq_mask), (np.asarray(qp.q), lb_s, ub_s, A_d, lb_d, ub_d)


def _oracle(qp):
    x_ref, status = solve_oracle_batch(*(np.asarray(v) for v in
                                         (qp.P, qp.q, qp.A, qp.lb, qp.ub)))
    assert (status == 0).all(), status
    return x_ref


def test_ipm_fov_flagship_control_deviation():
    """FoV flagship (m_d = 84, 4 CBF families, Voronoi rows, 7 ranked
    slack columns): cold-start IPM must beat the 1e-3 deviation bar by
    orders of magnitude, every lane converged."""
    B = 64
    ctrl, op, qp, _ = _fov_flagship_qps(B)
    x_ref = _oracle(qp)
    (P, A_s, eq_mask), args = _split_structured(ctrl, qp)

    ipm = StructuredIPM(P, A_s, eq_mask, ctrl.m_dynamic)
    sol = ipm.solve(*(jnp.asarray(a) for a in args))
    assert bool(np.all(np.asarray(sol.converged))), (
        f"unconverged: {np.nonzero(~np.asarray(sol.converged))[0]}, "
        f"mu={np.asarray(sol.mu)}, pri={np.asarray(sol.pri_res)}")

    U = np.asarray(op.U_basis)
    dev = np.abs((np.asarray(sol.z)[:, :36] - x_ref[:, :36]) @ U.T).max(axis=1)
    assert dev.max() < 1e-3, f"fov flagship IPM control deviation: {dev.max()}"
    # the residual tail is QP degeneracy, not solver error: on the worst
    # lane the IPM objective is LOWER than the oracle's (-1.5e-6 at
    # objective scale 1.5e6) with feasibility 7e-14 — both are ε-optimal
    # along near-flat directions created by the 5e4 slack weights. The
    # typical lane is near-exact:
    assert np.median(dev) < 1e-5, f"median deviation: {np.median(dev)}"


def test_ipm_connectivity_flagship_control_deviation():
    B = 32
    ctrl, op, qp, _ = _flagship_qps(B)
    x_ref = _oracle(qp)
    (P, A_s, eq_mask), args = _split_structured(ctrl, qp)

    ipm = StructuredIPM(P, A_s, eq_mask, ctrl.m_dynamic)
    sol = ipm.solve(*(jnp.asarray(a) for a in args))
    assert bool(np.all(np.asarray(sol.converged)))
    U = np.asarray(op.U_basis)
    dev = np.abs((np.asarray(sol.z)[:, :36] - x_ref[:, :36]) @ U.T).max(axis=1)
    # worst lane is again ε-optimal degeneracy (IPM objective -1.4e-8
    # BELOW the oracle's at μ = 4e-14)
    assert dev.max() < 1e-3, f"connectivity IPM control deviation: {dev.max()}"
    assert np.median(dev) < 1e-6, f"median deviation: {np.median(dev)}"


def test_ipm_x0_is_inert():
    """x0 is accepted for interface parity with StructuredQPOperator but
    deliberately ignored (primal-only warm starts measurably HURT IPM
    convergence — see ops/qp/ipm.py solve()); passing one must not change
    the result."""
    B = 16
    ctrl, op, qp, _ = _fov_flagship_qps(B, seed=11)
    x_ref = _oracle(qp)
    (P, A_s, eq_mask), args = _split_structured(ctrl, qp)
    ipm = StructuredIPM(P, A_s, eq_mask, ctrl.m_dynamic, IPMConfig(iters=10))
    cold = ipm.solve(*(jnp.asarray(a) for a in args))
    warm = ipm.solve(*(jnp.asarray(a) for a in args), x0=jnp.asarray(x_ref))
    np.testing.assert_array_equal(np.asarray(cold.z), np.asarray(warm.z))


def test_ipm_masked_neighbors_match_smaller_problem():
    """Rows masked via ±BIG (absent neighbors) must not perturb the
    solution: solve the 7-neighbor problem with 3 masked vs the oracle on
    the same (masked) dense QP."""
    B = 8
    ctrl, op, qp, (pos, vel, refs, blobs, mask) = _fov_flagship_qps(B, seed=5)
    from mpc_cbf_tpu.types import State
    mask = np.asarray(mask).copy()
    mask[:, 4:] = False
    mask_j = jnp.asarray(mask)
    H = ctrl.impc.cbf_horizon

    def build(p, v, r, nb, mk):
        x = jnp.concatenate([p, v])
        return ctrl.assemble(State(pos=p, vel=v), r, nb, mk,
                             jnp.broadcast_to(x, (H, 6)), jnp.arange(H) == 0)

    qp2 = jax.vmap(build)(pos, vel, refs, blobs, mask_j)
    x_ref = _oracle(qp2)
    (P, A_s, eq_mask), args = _split_structured(ctrl, qp2)
    ipm = StructuredIPM(P, A_s, eq_mask, ctrl.m_dynamic)
    sol = ipm.solve(*(jnp.asarray(a) for a in args))
    assert bool(np.all(np.asarray(sol.converged)))
    U = np.asarray(op.U_basis)
    dev = np.abs((np.asarray(sol.z)[:, :36] - x_ref[:, :36]) @ U.T).max(axis=1)
    assert dev.max() < 1e-3, dev.max()
    assert np.median(dev) < 1e-5, np.median(dev)


def test_hybrid_ipm_fov_flagship_certifies():
    """f32-entry + f64-tail hybrid (ops/qp/ipm.py::HybridIPM): ~1/3 the
    f64 iteration work of the cold run, same certification quality. The
    f32 state transfers via interiorization (warm_pad=1e-6) and
    neighborhood centering (width 10 at mu >= 1e-4) — without those the
    transfer measured 0.656 converged with shallow certifications
    (converged-lane deviation 1.3e-3 > bar); with them, >= 95% of lanes
    converge and every converged lane meets the TWO-PART certificate:

      (a) control deviation vs the exact oracle < 1e-3, OR
      (b) the lane is e-equal-optimal: feasible to 1e-9 and objective
          within 1e-5 (relative) of the oracle's.

    Part (b) exists because ~1-3% of random fov lanes are DEGENERATE:
    rank-decayed slack weights (50000 * 0.1^rank, rank up to 6 =>
    effective weight ~5e-3) leave near-flat valleys through control
    space, and two exact solvers legitimately land >1e-3 apart on the
    same optimal face. Measured (seeds 0/7/11): every such lane is
    feasible to ~1e-14 with objective within +-3e-7 relative of the
    oracle — usually BELOW it (the oracle stopped first). A deviation
    bound alone is not attainable there by ANY solver, CPLEX included."""
    from mpc_cbf_tpu.ops.qp.ipm import HybridIPM

    B = 64
    for seed in (0, 5, 11):
        ctrl, op, qp, _ = _fov_flagship_qps(B, seed=seed)
        x_ref = _oracle(qp)
        (P, A_s, eq_mask), args = _split_structured(ctrl, qp)

        hyb = HybridIPM(P, A_s, eq_mask, ctrl.m_dynamic)
        sol = hyb.solve(*(jnp.asarray(a) for a in args))
        conv = np.asarray(sol.converged)
        assert conv.mean() >= 0.95, (
            f"seed {seed}: hybrid converged only {conv.mean():.3f}: "
            f"mu={np.asarray(sol.mu)[~conv]}, "
            f"dual={np.asarray(sol.dual_res)[~conv]}")

        U = np.asarray(op.U_basis)
        z = np.asarray(sol.z)
        dev = np.abs((z[:, :36] - x_ref[:, :36]) @ U.T).max(axis=1)
        assert np.median(dev[conv]) < 1e-5, np.median(dev[conv])

        Pd = np.asarray(qp.P)
        Pd = Pd if Pd.ndim == 2 else Pd[0]
        qd, Ad = np.asarray(qp.q), np.asarray(qp.A)
        lb, ub = np.asarray(qp.lb), np.asarray(qp.ub)
        for i in np.nonzero(conv & (dev > 1e-3))[0]:
            o_ipm = 0.5 * z[i] @ Pd @ z[i] + qd[i] @ z[i]
            o_ref = 0.5 * x_ref[i] @ Pd @ x_ref[i] + qd[i] @ x_ref[i]
            rel = (o_ipm - o_ref) / max(abs(o_ref), 1.0)
            Ax = Ad[i] @ z[i]
            bscale = np.maximum(1.0, np.maximum(
                np.where(lb[i] > -BIG / 2, np.abs(lb[i]), 0.0),
                np.where(ub[i] < BIG / 2, np.abs(ub[i]), 0.0)))
            feas = max(np.max((lb[i] - Ax) / bscale),
                       np.max((Ax - ub[i]) / bscale))
            assert feas < 1e-9 and rel < 1e-5, (
                f"seed {seed} lane {i}: dev={dev[i]:.2e} is neither inside "
                f"the 1e-3 bar nor e-equal-optimal (feas={feas:.1e}, "
                f"rel_obj={rel:.2e})")
    # non-converged lanes must be flagged, not silently wrong — nothing to
    # assert on their deviation, but the flag must be exposed (checked
    # above via conv indexing)


def test_hybrid_ipm_through_structured_impc():
    """Full production route: StructuredIMPC(ctrl, HybridIPMConfig())
    drives the hybrid through assembly + the IMPC loop."""
    from mpc_cbf_tpu.types import State
    from mpc_cbf_tpu.ops.qp.ipm import HybridIPMConfig
    from mpc_cbf_tpu.controllers.mpc_cbf import StructuredIMPC

    B = 8
    ctrl, op, qp, (pos, vel, refs, blobs, mask) = _fov_flagship_qps(B)
    simpc = StructuredIMPC(ctrl, HybridIPMConfig())
    ref = jnp.asarray(refs)
    res = simpc.optimize_batch(State(pos=jnp.asarray(pos), vel=jnp.asarray(vel)),
                               ref, jnp.asarray(blobs), jnp.asarray(mask))
    assert bool(np.asarray(res.success).mean() >= 0.9)
    assert np.isfinite(np.asarray(res.coeffs)).all()


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_ipm_program_does_not_depend_on_backend(backend, monkeypatch):
    """No platform rule: the IPM traces the same program (library
    Cholesky, native-precision Gram) whatever jax.default_backend()
    reports, for the f64 and the f32 profiles."""
    from mpc_cbf_tpu.ops.qp.ipm import IPM_F32_ENTRY

    ctrl, op, qp, _ = _fov_flagship_qps(4)
    (P, A_s, eq_mask), args = _split_structured(ctrl, qp)
    args = tuple(jnp.asarray(a) for a in args)
    for cfg in (IPMConfig(), IPM_F32_ENTRY):
        ipm = StructuredIPM(P, A_s, eq_mask, ctrl.m_dynamic, cfg)
        # the untraced body, so no jit cache can hide a backend rule
        a = tuple(x.astype(ipm.dt) for x in args)
        ref = str(jax.make_jaxpr(ipm._solve)(*a, None))
        monkeypatch.setattr(jax, "default_backend", lambda: backend)
        got = str(jax.make_jaxpr(ipm._solve)(*a, None))
        monkeypatch.undo()
        assert got == ref
        assert "cholesky" in got
