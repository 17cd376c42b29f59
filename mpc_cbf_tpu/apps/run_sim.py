"""Config-driven simulation runner — the L6/L7 app layer.

Reference parity: the example mains
(``mpc_cbf/examples/connectivity/MPCCBFFormationControl_example.cpp:18-233``,
``mpc_cbf/examples/fov/BezierIMPCCBFPFXYYaw_example.cpp``) and the
run_mpccbf.sh pipeline: load base+task config, build the controller, run the
closed-loop sim, write a ``states.json`` in the reference's schema
(states["robots"][i]["states"]), and score with the collision/goal metrics.

Usage:
  python -m mpc_cbf_tpu.apps.run_sim --base configs/base_config.json \
      --task configs/tasks_4r_rotate.json --controller connectivity \
      --sim-runtime 6.0 --out /tmp/states.json
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import jax
import jax.numpy as jnp


CONTROLLERS = (
    "connectivity",       # ConnectivityIMPCCBF  (MPCCBFFormationControl_example)
    "fov",                # FovIMPCCBF           (BezierIMPCCBFPFXYYaw_example)
    "single-shot",        # BezierMPCCBF         (BezierMPCCBFXYYaw_example)
    "mpc",                # BezierMPC, no CBF    (BezierMPCXYYaw_example)
    "cbf-connectivity",   # ConnectivityControl  (CBFFormationControl_example)
    "cbf-fov",            # FovControl           (CBFControl_example, --pf for
                          #                       the particle-filter estimator)
)


def _fov_cbf(cfg: dict, mpc):
    from mpc_cbf_tpu.ops.cbf import FovCBF

    f = cfg.get("fov_cbf_params", {})
    beta = float(f.get("beta", 120.0)) * np.pi / 180.0
    return FovCBF(beta, float(f.get("Ds", 0.3)), float(f.get("Rs", 4.0)),
                  jnp.asarray(mpc.v_min), jnp.asarray(mpc.v_max))


def build_sim(cfg: dict, controller: str, num_robots: int, solver_iters: int,
              use_pf: bool = False, enable_connectivity: bool = False,
              certified: bool = False):
    from mpc_cbf_tpu.ops.cbf import ConnectivityCBF
    from mpc_cbf_tpu.ops.qp import ADMMConfig
    from mpc_cbf_tpu.controllers import (
        BezierMPC, BezierMPCOperator, BezierMPCCBF,
        ConnectivityIMPCCBF, FovIMPCCBF,
        FovCBFController, ConnectivityCBFController,
    )
    from mpc_cbf_tpu.parallel import MultiAgentSim, BezierMPCSim, CBFOnlySim
    from mpc_cbf_tpu.utils import config as cfgmod

    bez = cfgmod.parse_bezier_params(cfg)
    mpc = cfgmod.parse_mpc_params(cfg)
    impc = cfgmod.parse_impc_params(cfg)
    pos_std, vel_std = cfgmod.parse_noise(cfg)
    solver = ADMMConfig(iters=solver_iters)
    shape, _ = cfgmod.parse_collision_shape(cfg)
    half = np.asarray(shape, dtype=float) / 2.0 if np.ndim(shape) else np.zeros(3)

    if controller in ("connectivity", "fov", "single-shot", "mpc"):
        op = BezierMPCOperator(bez, mpc, dim=3)
        if controller == "connectivity":
            d_min, d_max = cfgmod.parse_cbf_distances(cfg)
            cbf = ConnectivityCBF(d_min, d_max, jnp.asarray(mpc.v_min),
                                  jnp.asarray(mpc.v_max))
            ctrl = ConnectivityIMPCCBF(op, cbf, impc, num_robots - 1, solver=solver,
                                       enable_connectivity=enable_connectivity)
        elif controller == "fov":
            ctrl = FovIMPCCBF(op, _fov_cbf(cfg, mpc), impc, num_robots - 1,
                              box_half_extents=half, solver=solver)
        elif controller == "single-shot":
            ctrl = BezierMPCCBF(op, _fov_cbf(cfg, mpc), num_robots - 1,
                                solver=solver)
        else:  # mpc
            ctrl = BezierMPC(op, num_robots - 1, box_half_extents=half,
                             solver=solver)
            return BezierMPCSim(ctrl, num_robots, noise_pos_std=pos_std,
                                noise_vel_std=vel_std), mpc
        # one structured solver launch per step for the whole agent batch.
        # fov runs the production solver (the f32 Mehrotra IPM: interior
        # iterates are feasible by construction); other controllers keep
        # the structured ADMM. --certified flies the accuracy-certified
        # pipeline (HYBRID_PROD: f32 entry + calibrated f64 tail; requires
        # jax_enable_x64).
        solver_cfg = None
        if certified:
            from mpc_cbf_tpu.ops.qp.ipm import HYBRID_PROD
            solver_cfg = HYBRID_PROD
        elif controller == "fov":
            from mpc_cbf_tpu.ops.qp.ipm import IPM_F32_ENTRY
            solver_cfg = IPM_F32_ENTRY
        return MultiAgentSim(ctrl, num_robots, noise_pos_std=pos_std,
                             noise_vel_std=vel_std, structured=True,
                             solver_cfg=solver_cfg), mpc

    # single-step controllers read the same slack knobs as the reference
    # examples (CBFFormationControl_example.cpp:94-96,165)
    slack = dict(slack_mode=impc.slack_mode, slack_cost=impc.slack_cost,
                 slack_decay_rate=impc.slack_decay_rate)
    if controller == "cbf-fov":
        ctrl = FovCBFController(_fov_cbf(cfg, mpc), num_robots - 1,
                                u_min=mpc.a_min, u_max=mpc.a_max,
                                solver=solver, **slack)
        return CBFOnlySim(ctrl, num_robots, dt=mpc.h, use_pf=use_pf), mpc
    if controller == "cbf-connectivity":
        d_min, d_max = cfgmod.parse_cbf_distances(cfg)
        cbf = ConnectivityCBF(d_min, d_max, jnp.asarray(mpc.v_min),
                              jnp.asarray(mpc.v_max))
        ctrl = ConnectivityCBFController(cbf, num_robots, solver=solver, **slack)
        return CBFOnlySim(ctrl, num_robots, dt=mpc.h), mpc
    raise ValueError(f"unknown controller {controller!r} ({'|'.join(CONTROLLERS)})")


def main(argv=None) -> int:
    from mpc_cbf_tpu.types import State
    from mpc_cbf_tpu.utils import config as cfgmod
    from mpc_cbf_tpu.utils.metrics import instance_success, instance_success_ref

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--base", required=True)
    p.add_argument("--task", required=True)
    p.add_argument("--controller", default="connectivity", choices=list(CONTROLLERS))
    p.add_argument("--pf", action="store_true",
                   help="cbf-fov only: estimate neighbors with per-pair "
                        "particle filters (FOV negative-information update)")
    p.add_argument("--sim-runtime", type=float, default=6.0)
    p.add_argument("--solver-iters", type=int, default=200)
    p.add_argument("--enable-connectivity", action="store_true",
                   help="turn on the MPC-level lambda2/CLF constraint family "
                        "(the block the reference ships commented out, "
                        "ConnectivityIMPCCBF.cpp:144-157)")
    p.add_argument("--certified", action="store_true",
                   help="IMPC controllers: fly the accuracy-certified "
                        "pipeline (HYBRID_PROD f32 entry + calibrated f64 "
                        "tail; every certified curve <1e-3 vs the exact "
                        "optimum). Enables jax_enable_x64.")
    p.add_argument("--out", default="states.json")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--platform", default=None,
                   help="select the JAX backend (cpu/gpu), like JAX_PLATFORMS; "
                        "default: JAX's own choice")
    args = p.parse_args(argv)

    if args.platform:
        from mpc_cbf_tpu.utils.runtime import force_platform
        force_platform(args.platform)
    from mpc_cbf_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    if args.certified:
        jax.config.update("jax_enable_x64", True)

    cfg = cfgmod.load_config(args.base, args.task)
    so, sf = cfgmod.parse_tasks(cfg)
    R = so.shape[0]
    sim, mpc = build_sim(cfg, args.controller, R, args.solver_iters, use_pf=args.pf,
                         enable_connectivity=args.enable_connectivity,
                         certified=args.certified)

    steps = int(round(args.sim_runtime / mpc.h))
    init = State(pos=jnp.asarray(so, jnp.float32), vel=jnp.zeros((R, 3), jnp.float32))
    goals = jnp.asarray(sf, jnp.float32)

    t0 = time.time()
    res = sim.rollout(init, goals, steps, key=jax.random.PRNGKey(args.seed))
    res = jax.block_until_ready(res)
    traj = np.asarray(res.traj_pos)   # [T, R, 3]
    vels = np.asarray(res.traj_vel)
    wall = time.time() - t0

    # states.json in the reference's schema
    out = {"dt": mpc.h, "Ts": mpc.Ts, "robots": {}}
    for i in range(R):
        rec = {
            "states": np.concatenate([traj[:, i], vels[:, i]], axis=-1).tolist(),
            "goal": sf[i].tolist(),
        }
        # estimator logs, reference schema (states["robots"][i]
        # ["estimates_mean"|"estimates_cov"],
        # BezierIMPCCBFPFXYYaw_example.cpp:204-280)
        if hasattr(res, "est_mean"):
            rec["estimates_mean"] = np.asarray(res.est_mean)[:, i].tolist()
            rec["estimates_cov"] = np.asarray(res.est_cov)[:, i].tolist()
        out["robots"][str(i)] = rec
    with open(args.out, "w") as f:
        json.dump(out, f)

    shape, shape_type = cfgmod.parse_collision_shape(cfg)
    coll = (np.asarray(shape[:2]) if shape_type == "box" else shape)
    ok, makespan = instance_success(
        traj.transpose(1, 0, 2), sf, radius=1.0,
        collision_shape=coll, shape_type=shape_type,
    )
    # the reference's own scoring is collision-only (its goal-miss return
    # is commented out, collision_check.py:56-59)
    ok_ref, _ = instance_success_ref(
        traj.transpose(1, 0, 2), sf, radius=1.0,
        collision_shape=coll, shape_type=shape_type,
    )
    dev = jax.devices()[0]
    summary = {
        "controller": args.controller, "num_robots": R, "steps": steps,
        "success": bool(ok), "makespan": makespan, "success_ref": bool(ok_ref),
        "wall_s": round(wall, 2),
        "solver_success_rate": float(np.asarray(res.success, dtype=np.float32).mean()),
        "out": args.out,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    # fraction of flown curves carrying the <1e-3 accuracy certificate
    # (certifying solvers only — see SimResult.certified)
    if args.certified and getattr(res, "certified", None) is not None:
        summary["certified_rate"] = float(
            np.asarray(res.certified, dtype=np.float32).mean())
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
