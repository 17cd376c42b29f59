"""Benchmark: MPC-CBF QP solves/s on the default device.

Measures the full flagship control path — per-agent QP assembly (autodiff
CBF rows, Voronoi rows, cost contraction) + the iterative IMPC loop
(impc_iter batched solves) — for a large batch of independent
agent-scenarios in lockstep, i.e. exactly the per-robot work of the
reference's controllers times batch.

Usage: python bench.py [batch|0] [mode[+accuracy]]   (0 = mode default)

Modes (second positional arg, default "fov"):
  fov           FovIMPCCBF, slack_mode=true, 7 neighbors (8-robot team):
                the reference's FLAGSHIP variant
                (``FovBezierIMPCCBF.cpp:47-223``) — 4 CBF families x
                cbf_horizon x 7 rows + 7 x piece-0 Voronoi rows + 7 slack
                columns, m_d ~ 84.
  connectivity  ConnectivityIMPCCBF, 3 neighbors (the cheapest variant).
The raw path solves with the f32 Mehrotra IPM (interior iterates are
feasible by construction); BENCH_SOLVER=admm switches to the structured
ADMM.
Append "+polish" to run the f64 active-set polish after the f32 ADMM —
the certified-accuracy configuration for the connectivity variant
(<1e-3 control deviation vs the exact oracle, tests/test_polish.py).
Append "+ipm" to solve with the f64 batched Mehrotra IPM — every lane
to ~1e-8 typical deviation (tests/test_ipm.py).
Append "+hybrid" for the f32-entry + f64-tail hybrid IPM
(ops/qp/ipm.py::HybridIPM) — full certification bars on both IMPC
iterations.
Append "+certified" for the SHIPPING certified pipeline (HYBRID_PROD):
f32-entry-only iter 0 + entry + calibrated 12-iteration f64 tail on
iter 1; the flown curve carries the <1e-3 two-part certificate
(certified_rate in the output).

Emits ONE JSON line with the metric, the usable and certified rates, the
batch, and the device it ran on (platform, device_kind, count).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def controller(mode: str):
    """The bench's controller for `mode`: (ctrl, IMPCParams)."""
    import jax.numpy as jnp

    from mpc_cbf_tpu.ops.cbf import ConnectivityCBF, FovCBF
    from mpc_cbf_tpu.ops.qp import ADMMConfig
    from mpc_cbf_tpu.controllers import (
        BezierParams, MPCParams, BezierMPCOperator, IMPCParams,
        ConnectivityIMPCCBF, FovIMPCCBF,
    )

    mpc = MPCParams()
    op = BezierMPCOperator(BezierParams(), mpc, dim=3)
    # iteration budget knob for tuning runs (the default is the
    # production configuration)
    solver = ADMMConfig(iters=int(os.environ.get("BENCH_SOLVER_ITERS", "200")))
    if mode == "fov":
        # reference flagship team of 8 (ScaleScript.sh); FovBezierIMPCCBF
        # always slacks. fov_cbf_params (base_config.json: beta=120deg,
        # Ds=0.3, Rs=6.0) and robot collision box aligned_box=[0.2,0.2,0]
        # (half extents [0.1,0.1,0] shift the Voronoi hyperplanes)
        impc = IMPCParams(slack_mode=True)
        cbf = FovCBF(120.0 * np.pi / 180.0, 0.3, 6.0, jnp.asarray(mpc.v_min),
                     jnp.asarray(mpc.v_max))
        return FovIMPCCBF(op, cbf, impc, 7, box_half_extents=np.array([0.1, 0.1, 0.0]),
                          solver=solver), impc
    impc = IMPCParams()
    cbf = ConnectivityCBF(1.0, 4.0, jnp.asarray(mpc.v_min), jnp.asarray(mpc.v_max))
    return ConnectivityIMPCCBF(op, cbf, impc, 3, solver=solver), impc


def scenario(mode: str, batch: int, rng: np.random.Generator):
    """Random lanes for `mode`: (pos, vel, ref, neighbor blob, mask) as
    float32 / bool numpy arrays."""
    from mpc_cbf_tpu.controllers import MPCParams

    N = 7 if mode == "fov" else 3
    if mode == "fov":
        # neighbor blob [N, 5]: xy + cov(0,0), cov(0,1), cov(1,1)
        ang = rng.uniform(0, 2 * np.pi, (batch, N))
        rad = rng.uniform(1.0, 3.5, (batch, N))
        cov = np.broadcast_to(np.array([0.05, 0.0, 0.05]), (batch, N, 3))
        nbr = np.concatenate([
            (rad * np.cos(ang))[..., None], (rad * np.sin(ang))[..., None],
            cov], axis=-1)
    else:
        ang = rng.uniform(0, 2 * np.pi, (batch, N))
        rad = rng.uniform(2.5, 4.0, (batch, N))
        nbr_pos = np.stack([rad * np.cos(ang), rad * np.sin(ang),
                            np.zeros_like(rad)], axis=-1)
        nbr_vel = rng.normal(0, 0.5, (batch, N, 3))
        nbr = np.concatenate([nbr_pos, nbr_vel], axis=-1)
    pos = rng.normal(0, 0.3, (batch, 3))
    vel = rng.normal(0, 0.5, (batch, 3))
    goals = rng.normal(0, 3.0, (batch, 3))
    ref = np.tile(goals[:, None, :], (1, MPCParams().k_hor, 1)).reshape(batch, -1)
    f32 = np.float32
    return (pos.astype(f32), vel.astype(f32), ref.astype(f32), nbr.astype(f32),
            np.ones((batch, N), bool))


def build(mode: str, batch: int, accuracy: str = ""):
    """accuracy: "" (raw f32 IPM), "polish" (f32 ADMM + f64 active-set
    polish), "ipm" (cold f64 IPM), "hybrid" or "certified" (f32 entry +
    f64 tail). Returns (jitted control_batch(), impc_iter)."""
    import jax
    import jax.numpy as jnp

    from mpc_cbf_tpu.types import State
    from mpc_cbf_tpu.ops.qp import IPMConfig
    from mpc_cbf_tpu.ops.qp.structured import StructuredConfig
    from mpc_cbf_tpu.controllers.mpc_cbf import StructuredIMPC

    ctrl, impc = controller(mode)
    if accuracy == "ipm":
        simpc = StructuredIMPC(ctrl, IPMConfig())
    elif accuracy == "hybrid":
        from mpc_cbf_tpu.ops.qp.ipm import HybridIPMConfig
        simpc = StructuredIMPC(ctrl, HybridIPMConfig())
    elif accuracy == "certified":
        # the shipping certified pipeline: f32-entry-only IMPC iter 0 +
        # entry + calibrated 12-iteration f64 tail on iter 1
        # (ops/qp/ipm.py::HYBRID_PROD; bars measured to imply the <1e-3
        # two-part certificate with zero leaks, scripts/calibrate_tail.py)
        from mpc_cbf_tpu.ops.qp.ipm import HYBRID_PROD
        simpc = StructuredIMPC(ctrl, HYBRID_PROD)
    elif accuracy == "" and os.environ.get("BENCH_SOLVER", "ipm") != "admm":
        # raw production path: the f32 Mehrotra IPM. INTERIOR
        # (feasible-by-construction) iterates lift fov usable 0.69 ->
        # 0.997 (the ADMM failures stall on the sampled accel/vel bound
        # rows — 92% of failed lanes, scripts/diagnose_fov_failures).
        # BENCH_SOLVER=admm switches to the structured ADMM.
        from mpc_cbf_tpu.ops.qp.ipm import IPM_F32_ENTRY
        simpc = StructuredIMPC(ctrl, IPM_F32_ENTRY)
    else:
        # iters_tail=64: IMPC iterations > 0 enter warm (previous
        # iterate's primal + carried ADMM duals) and need only ~1/3 the
        # cold budget — measured usable rate 47/64 at 200+64 warm vs
        # 46/64 at 200+200 cold on the fov flagship ensemble
        # (tests/test_warm_start.py pins this)
        simpc = StructuredIMPC(ctrl, StructuredConfig(
            iters=ctrl.solver.iters,
            iters_tail=int(os.environ.get("BENCH_ITERS_TAIL", "64")),
            polish=(accuracy == "polish")))

    pos, vel, ref, nbr, mask = (jnp.asarray(a) for a in
                                scenario(mode, batch, np.random.default_rng(0)))

    # jit the WHOLE call (assembly + IMPC solves): without this the
    # vmapped QP assembly dispatches eagerly op-by-op inside the timed
    # region. polish_structured's x64 check raises at TRACE time, so the
    # polish path jits too.
    @jax.jit
    def control_batch():
        res = simpc.optimize_batch(State(pos=pos, vel=vel), ref, nbr, mask)
        return res.coeffs, res.success, res.certified

    return control_batch, impc.impc_iter


def main() -> None:
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else None
    if batch == 0:
        batch = None  # "0" = use the mode default (lets spec be argv[2])
    spec = sys.argv[2] if len(sys.argv) > 2 else "fov"
    mode, _, accuracy = spec.partition("+")

    import jax
    if accuracy in ("polish", "ipm", "hybrid", "certified"):
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    if batch is None:
        # fov lanes carry ~10x the per-lane state of connectivity lanes
        # (m_d ~ 84 vs 6). These sizes are not yet re-derived for the
        # current card (ROADMAP S4).
        batch = 8192 if mode == "fov" else 32768

    control_batch, impc_iter = build(mode, batch, accuracy)

    def run_once():
        return jax.block_until_ready(control_batch())

    out = run_once()  # warmup / compile
    # usable-lane rate: the reference only counts CPLEX-OPTIMAL solves
    # (MPCCBFFormationControl_example.cpp:150-164); a throughput number
    # must carry the fraction of lanes whose result is actually flyable
    success_rate = float(jnp.mean(out[1]))
    # flown-curve certification rate (<1e-3 two-part certificate) — only
    # certifying configs set it (see IMPCResult.certified)
    certified_rate = float(jnp.mean(out[2]))

    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        run_once()
    dt = (time.perf_counter() - t0) / reps

    qp_solves = batch * impc_iter
    solves_per_s = qp_solves / dt
    # historical metric names: "…_polished" for the polish mode, "…_ipm"
    # for ipm
    suffix = {"": "", "polish": "_polished", "ipm": "_ipm",
              "hybrid": "_hybrid", "certified": "_certified"}[accuracy]
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": f"mpccbf_{mode}_qp_solves_per_s{suffix}",
        "value": round(solves_per_s, 1),
        "unit": "solves/s",
        "success_rate": round(success_rate, 4),
        "usable_solves_per_s": round(solves_per_s * success_rate, 1),
        "certified_rate": round(certified_rate, 4),
        "certified_solves_per_s": round(solves_per_s * certified_rate, 1),
        "batch": batch,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
