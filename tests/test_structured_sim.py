"""Structured (batched-solver) MultiAgentSim vs the dense path."""
import numpy as np
import jax
import jax.numpy as jnp

from mpc_cbf_tpu.types import State
from mpc_cbf_tpu.ops.cbf import ConnectivityCBF
from mpc_cbf_tpu.ops.qp import ADMMConfig
from mpc_cbf_tpu.controllers import (
    BezierParams, MPCParams, BezierMPCOperator, IMPCParams, ConnectivityIMPCCBF,
)
from mpc_cbf_tpu.parallel import MultiAgentSim
from mpc_cbf_tpu.utils.instances import circle_rotate_instance


def test_structured_sim_matches_dense_behavior():
    mpc = MPCParams()
    op = BezierMPCOperator(BezierParams(), mpc, dim=3)
    cbf = ConnectivityCBF(1.0, 4.0, jnp.asarray(mpc.v_min), jnp.asarray(mpc.v_max))
    ctrl = ConnectivityIMPCCBF(op, cbf, IMPCParams(), 3,
                               solver=ADMMConfig(iters=200))
    inst = circle_rotate_instance(4, radius=2.5)
    so = np.asarray(inst["tasks"]["so"], np.float32)
    sf = np.asarray(inst["tasks"]["sf"], np.float32)
    init = State(pos=jnp.asarray(so), vel=jnp.zeros((4, 3), jnp.float32))
    goals = jnp.asarray(sf)

    res_d = MultiAgentSim(ctrl, 4, structured=False).rollout(init, goals, 40)
    res_s = MultiAgentSim(ctrl, 4, structured=True).rollout(init, goals, 40)

    for res in (res_d, res_s):
        traj = np.asarray(res.traj_pos)
        err = np.linalg.norm(traj[-1, :, :2] - sf[:, :2], axis=-1)
        assert err.max() < 0.5, err
        d = traj[:, :, None, :2] - traj[:, None, :, :2]
        dist = np.linalg.norm(d, axis=-1) + np.eye(4) * 1e9
        assert dist.min() > 1.0
        assert np.asarray(res.success).mean() > 0.9


def test_fov_sensing_radius_masks_far_neighbors():
    """FoV sims scope the constraint set to the sensing radius
    (sim.py::MultiAgentSim.sensing_radius). The reference's estimator
    produces the same scoping physically: a target beyond the FOV range
    never gets measurement updates (pf_applications.cpp:8-45), so its
    rows are never driven by true positions. Feeding true far-teammate
    positions activates Rs-range rows against robots ~2 Rs away and
    drags the team inward (measured: 10-robot radius-5 ring stalls
    ~1.7 m short of every goal at 99% solver convergence)."""
    from mpc_cbf_tpu.ops.cbf import FovCBF
    from mpc_cbf_tpu.controllers import FovIMPCCBF

    mpc = MPCParams()
    op = BezierMPCOperator(BezierParams(), mpc, dim=3)
    beta = 120.0 * np.pi / 180.0
    cbf = FovCBF(beta, 0.3, 6.0, jnp.asarray(mpc.v_min), jnp.asarray(mpc.v_max))
    ctrl = FovIMPCCBF(op, cbf, IMPCParams(slack_mode=True), 3,
                      solver=ADMMConfig(iters=50))

    # square: adjacent pairs ~5.7 m (inside Rs=6), diagonals 8 m (outside)
    r = 4.0
    so = np.array([[r, 0, 0], [0, r, 0], [-r, 0, 0], [0, -r, 0]], np.float32)
    st = State(pos=jnp.asarray(so), vel=jnp.zeros((4, 3), jnp.float32))

    sim = MultiAgentSim(ctrl, 4)
    mask = np.asarray(sim._neighbor_mask(st, sim._blobs(st)))
    assert mask.shape == (4, 3)
    # each agent: 2 adjacent neighbors visible, 1 diagonal masked
    assert (mask.sum(axis=1) == 2).all(), mask
    # diagonal of agent 0 is agent 2 -> blob slot 1 (others = [1,2,3])
    assert not mask[0, 1]

    # sensing_radius <= 0 disables the mask
    sim_off = MultiAgentSim(ctrl, 4, sensing_radius=0.0)
    assert np.asarray(sim_off._neighbor_mask(st, sim_off._blobs(st))).all()


def test_fov_ipm_production_sim_closed_loop():
    """The round-5 fov production solver (f32 Mehrotra IPM) and the
    certified pipeline (HYBRID_PROD) both fly the 4-robot rotate
    instance closed-loop: goals reached, no close approach, solver
    success ~1. Mirrors what bench.py/__graft_entry__ ship."""
    from mpc_cbf_tpu.ops.cbf import FovCBF
    from mpc_cbf_tpu.ops.qp.ipm import HYBRID_PROD, IPM_F32_ENTRY
    from mpc_cbf_tpu.controllers import FovIMPCCBF

    mpc = MPCParams()
    op = BezierMPCOperator(BezierParams(), mpc, dim=3)
    beta = 120.0 * np.pi / 180.0
    cbf = FovCBF(beta, 0.3, 6.0, jnp.asarray(mpc.v_min),
                 jnp.asarray(mpc.v_max))
    ctrl = FovIMPCCBF(op, cbf, IMPCParams(slack_mode=True), 3,
                      box_half_extents=np.array([0.1, 0.1, 0.0]))
    inst = circle_rotate_instance(4, radius=2.5)
    so = np.asarray(inst["tasks"]["so"], np.float32)
    sf = np.asarray(inst["tasks"]["sf"], np.float32)
    init = State(pos=jnp.asarray(so), vel=jnp.zeros((4, 3), jnp.float32))
    goals = jnp.asarray(sf)

    for cfg in (IPM_F32_ENTRY, HYBRID_PROD):
        sim = MultiAgentSim(ctrl, 4, structured=True, solver_cfg=cfg)
        res = sim.rollout(init, goals, 40)
        traj = np.asarray(res.traj_pos)
        err = np.linalg.norm(traj[-1, :, :2] - sf[:, :2], axis=-1)
        assert err.max() < 0.5, (type(cfg).__name__, err)
        d = traj[:, :, None, :2] - traj[:, None, :, :2]
        dist = np.linalg.norm(d, axis=-1) + np.eye(4) * 1e9
        assert dist.min() > 0.3
        assert np.asarray(res.success).mean() > 0.9
        # the per-step certificate propagates through the rollout: the
        # certified pipeline certifies most flown curves, the raw f32
        # profile must certify NONE
        cert_rate = float(np.asarray(res.certified).mean())
        if cfg is HYBRID_PROD:
            assert cert_rate >= 0.8, cert_rate
        else:
            assert cert_rate == 0.0, cert_rate
