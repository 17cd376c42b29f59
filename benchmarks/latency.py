"""Per-control-step latency vs the reference real-time budget.

The reference's implied budget: one replan (impc_iter=2 QP solves) per
robot per h = 100 ms on CPU (base_config.json:3; the ROS deployment runs
the optimizer timer at h, control_node.cpp:195-197). This measures the
full control step (CBF assembly + 2 batched solves) for whole TEAMS in
lockstep and reports p50/p95/p99 wall latency.

Usage: python benchmarks/latency.py [team_size] [num_teams] [mode]
  mode: "fov" (flagship: 4 CBF families + Voronoi + ranked slack,
        FovBezierIMPCCBF.cpp:47-223) or "connectivity" (default fov)
"""

from __future__ import annotations

import json
import os
import sys

# runnable as a plain script: put the repo root on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

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
    from mpc_cbf_tpu.utils.profiling import StepTimer

    A = int(sys.argv[1]) if len(sys.argv) > 1 else 8     # robots per team
    teams = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    mode = sys.argv[3] if len(sys.argv) > 3 else "fov"

    mpc = MPCParams()
    op = BezierMPCOperator(BezierParams(), mpc, dim=3)
    if mode == "fov":
        beta = 120.0 * np.pi / 180.0
        cbf = FovCBF(beta, 0.3, 6.0, jnp.asarray(mpc.v_min),
                     jnp.asarray(mpc.v_max))
        ctrl = FovIMPCCBF(op, cbf, IMPCParams(slack_mode=True), A - 1,
                          box_half_extents=np.array([0.1, 0.1, 0.0]))
    else:
        cbf = ConnectivityCBF(1.0, 4.0, jnp.asarray(mpc.v_min),
                              jnp.asarray(mpc.v_max))
        ctrl = ConnectivityIMPCCBF(op, cbf, IMPCParams(), A - 1)
    if mode == "fov":
        # fov production solver (mirrors bench.py): f32 Mehrotra IPM —
        # usable rate 0.99 vs the structured ADMM's 0.69
        from mpc_cbf_tpu.ops.qp.ipm import IPM_F32_ENTRY
        simpc = StructuredIMPC(ctrl, IPM_F32_ENTRY)
    else:
        simpc = StructuredIMPC(ctrl, StructuredConfig(iters=200))

    B = A * teams
    rng = np.random.default_rng(0)
    ang = 2 * np.pi * np.arange(A) / A
    base = np.stack([3 * np.cos(ang), 3 * np.sin(ang), np.zeros(A)], -1)
    pos = np.tile(base, (teams, 1)) + rng.normal(0, 0.05, (B, 3))
    cur = State(pos=jnp.asarray(pos, jnp.float32),
                vel=jnp.zeros((B, 3), jnp.float32))
    goals = jnp.asarray(np.tile(np.roll(base, -1, 0), (teams, 1)), jnp.float32)
    ref = jnp.tile(goals, (1, mpc.k_hor))
    # neighbors within the team
    if mode == "fov":
        blob = np.zeros((B, A - 1, 5), np.float32)
        for t in range(teams):
            for i in range(A):
                others = [t * A + j for j in range(A) if j != i]
                blob[t * A + i, :, :2] = pos[others][:, :2]
                blob[t * A + i, :, 2] = 0.05   # cov_xx
                blob[t * A + i, :, 4] = 0.05   # cov_yy
    else:
        blob = np.zeros((B, A - 1, 6), np.float32)
        for t in range(teams):
            for i in range(A):
                others = [t * A + j for j in range(A) if j != i]
                blob[t * A + i, :, :3] = pos[others]
    blob = jnp.asarray(blob)
    mask = jnp.ones((B, A - 1), bool)

    step = jax.jit(lambda c, r, b, m: simpc.optimize_batch(c, r, b, m).coeffs)
    jax.block_until_ready(step(cur, ref, blob, mask))  # compile

    timer = StepTimer()
    for _ in range(50):
        with timer.measure():
            jax.block_until_ready(step(cur, ref, blob, mask))
    s = timer.stats()
    s.update({"metric": "control_step_latency", "mode": mode, "team_size": A,
              "teams": teams, "budget_ms": mpc.h * 1e3,
              "within_budget_p99": s["p99_ms"] <= mpc.h * 1e3})
    print(json.dumps(s))


if __name__ == "__main__":
    main()
