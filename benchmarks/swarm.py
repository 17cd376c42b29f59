"""Large-scale swarm capability benchmark (BASELINE.json config 5:
"1000+-scenario batched swarm (32 agents) across hosts").

Runs S independent 32-agent scenarios in lockstep: every (scenario,
agent) pair is one lane of the batched solve — S*32 MPC-CBF QPs per
IMPC iteration, 2 iterations per control step. On several devices or
processes, shard the scenario axis with parallel.distributed.

Usage: python benchmarks/swarm.py [scenarios] [agents] [steps] [mode]
  mode: "connectivity" (default) or "fov" (flagship families: 4 CBF rows
  x horizon per neighbor + Voronoi + ranked slack columns)
"""

from __future__ import annotations

import json
import os
import sys

# runnable as a plain script: put the repo root on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

import numpy as np


def main() -> None:
    import jax
    import jax.numpy as jnp

    from mpc_cbf_tpu.types import State
    from mpc_cbf_tpu.ops.cbf import ConnectivityCBF, FovCBF
    from mpc_cbf_tpu.ops.qp.structured import StructuredConfig
    from mpc_cbf_tpu.controllers import (
        BezierParams, MPCParams, BezierMPCOperator, IMPCParams,
        ConnectivityIMPCCBF, FovIMPCCBF, StructuredIMPC,
    )

    S = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    A = int(sys.argv[2]) if len(sys.argv) > 2 else 32
    steps = int(sys.argv[3]) if len(sys.argv) > 3 else 5
    mode = sys.argv[4] if len(sys.argv) > 4 else "connectivity"

    mpc = MPCParams()
    op = BezierMPCOperator(BezierParams(), mpc, dim=3)
    if mode == "fov":
        beta = 120.0 * np.pi / 180.0
        cbf = FovCBF(beta, 0.3, 6.0, jnp.asarray(mpc.v_min),
                     jnp.asarray(mpc.v_max))
        ctrl = FovIMPCCBF(op, cbf, IMPCParams(slack_mode=True), A - 1,
                          box_half_extents=np.array([0.1, 0.1, 0.0]))
    else:
        cbf = ConnectivityCBF(1.0, 6.0, jnp.asarray(mpc.v_min),
                              jnp.asarray(mpc.v_max))
        ctrl = ConnectivityIMPCCBF(op, cbf, IMPCParams(), A - 1)
    # fov at swarm scale: rows from ALL A-1 neighbors of a 32-agent ring
    # are mostly beyond the Rs=6 sensing barrier (the rows are infeasible
    # at entry — measured success 0.0 with an all-on mask), so fov mode
    # range-masks neighbors to the sensing radius below.
    #
    # Solver: the f32 Mehrotra IPM (the production path, mirrors
    # bench.py). Besides the usable-rate advantage, the IPM carries NO
    # per-lane [m_d, m_d] tensor — at m_d = 372 the ADMM's Woodbury
    # blocks are 3 x 18.9 GB at full batch (forcing lane-chunking) while
    # the IPM's largest per-lane tensor is [m_d, nz] — so swarm scale
    # fits device memory without chunking. SWARM_SOLVER=admm reverts to the deep-
    # budget ADMM (600 iters, measured 1.00 usable on the masked ring).
    if os.environ.get("SWARM_SOLVER", "ipm") != "admm":
        from mpc_cbf_tpu.ops.qp.ipm import IPM_F32_ENTRY
        simpc = StructuredIMPC(ctrl, IPM_F32_ENTRY)
    else:
        simpc = StructuredIMPC(ctrl, StructuredConfig(
            iters=600 if mode == "fov" else 100,
            iters_tail=200 if mode == "fov" else None))

    rng = np.random.default_rng(0)
    ang = 2 * np.pi * np.arange(A) / A
    R = max(4.0, A * 1.2 / (2 * np.pi) * 2)       # ring with >1.2 m spacing
    base = np.stack([R * np.cos(ang), R * np.sin(ang), np.zeros(A)], -1)
    pos0 = base[None] + rng.normal(0, 0.05, (S, A, 3))
    goals = np.roll(base, -1, axis=0)[None].repeat(S, 0)

    others_idx = np.stack([np.delete(np.arange(A), i) for i in range(A)])

    @jax.jit
    def control_step(pos, vel):
        B = S * A
        if mode == "fov":
            xy = pos[:, others_idx, :2]                     # [S, A, A-1, 2]
            cov = jnp.broadcast_to(
                jnp.array([0.05, 0.0, 0.05], jnp.float32), (S, A, A - 1, 3))
            blob = jnp.concatenate([xy, cov], -1).reshape(B, A - 1, 5)
        else:
            allx = jnp.concatenate([pos, vel], -1)          # [S, A, 6]
            blob = allx[:, others_idx].reshape(B, A - 1, 6)
        cur = State(pos=pos.reshape(B, 3), vel=vel.reshape(B, 3))
        ref = jnp.tile(jnp.asarray(goals.reshape(B, 3), jnp.float32),
                       (1, mpc.k_hor))
        if mode == "fov":
            # sensing-range neighbor mask (see the iteration-budget note)
            d = jnp.linalg.norm(cur.pos[:, None, :2] - blob[:, :, :2], axis=-1)
            mask = d < 5.5
        else:
            mask = jnp.ones((B, A - 1), bool)
        res = simpc.optimize_batch(cur, ref, blob, mask)
        E0 = jnp.asarray(op.pw.eval_matrix([mpc.h], 0), jnp.float32)
        E1 = jnp.asarray(op.pw.eval_matrix([mpc.h], 1), jnp.float32)
        new_pos = (res.coeffs @ E0.T).reshape(S, A, 3)
        new_vel = (res.coeffs @ E1.T).reshape(S, A, 3)
        ok = res.flyable.reshape(S, A)
        new_pos = jnp.where(ok[..., None], new_pos, pos)
        new_vel = jnp.where(ok[..., None], new_vel, 0.0)
        return new_pos, new_vel, res.success.reshape(S, A)

    pos = jnp.asarray(pos0, jnp.float32)
    vel = jnp.zeros((S, A, 3), jnp.float32)
    pos, vel, succ = jax.block_until_ready(control_step(pos, vel))  # compile

    t0 = time.perf_counter()
    rates = []
    for _ in range(steps):
        pos, vel, succ = control_step(pos, vel)
        rates.append(succ)
    jax.block_until_ready(pos)
    dt = (time.perf_counter() - t0) / steps

    qps = S * A * 2  # QPs per control step (impc_iter = 2)
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "swarm_qp_solves_per_s",
        "scenarios": S, "agents": A,
        "qp_per_step": qps,
        "step_wall_s": round(dt, 3),
        "solves_per_s": round(qps / dt, 1),
        "solver_success_rate": round(
            float(jnp.mean(jnp.stack(rates).astype(jnp.float32))), 4),
        "finite": bool(jnp.all(jnp.isfinite(pos)) & jnp.all(jnp.isfinite(vel))),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
