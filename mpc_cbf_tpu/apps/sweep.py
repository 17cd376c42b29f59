"""Batched scenario sweep — the batched replacement for ScaleScript.sh.

Where the reference launches independent simulator processes in a bash loop
(``experiments/bash/ScaleScript.sh:6-35``: num_robots 2-10 x FOV
{120,240,360} x 15 seeds in parallel via ``&``), here every seed of a grid
point is one lane of a *batched scenario axis*: all seeds run in lockstep
inside a single jitted rollout, sharded across the device mesh
(``parallel.sharded_rollout``). A whole 15-seed cell costs barely more
than one sim, and grid cells that share (controller, R) reuse the
compiled executable.

The RSS-2025 grid axes (Statistics.py:24-35 panels):
  --sizes        team sizes (reference: 2..10)
  --fovs         FOV beta in degrees (reference: 120 240 360) — applies
                 to the fov/single-shot/cbf-fov controllers
  --slack-decays slack_decay_rate values (reference sweeps the decay of
                 the distance-ranked slack weights)

Usage:
  python -m mpc_cbf_tpu.apps.sweep --base configs/base_config.json \
      --sizes 2 4 6 8 10 --seeds 15 --controller fov \
      --fovs 120 240 360 --slack-decays 0.1 \
      --sim-runtime 6.0 --out /tmp/sweep.jsonl [--platform cpu]
"""

from __future__ import annotations

import argparse
import copy
import json
import time

import numpy as np


def run_cell(cfg, controller, R, seeds, steps, solver_iters, start_noise=0.05,
             fov=None, slack_decay=None, radius=4.0, mesh=None, return_result=False):
    """One grid cell: (controller, R, fov, slack_decay) x seeds lanes.

    radius: circle radius for the rotate instance. The reference uses a
    FIXED radius 4 for every team size
    (``experiments/python/instances/generate_fov_instance.py:89``).
    mesh: device mesh the seeds are sharded over (default: every device
    on the scenario axis). return_result: also return the SimResult."""
    import jax
    import jax.numpy as jnp

    from mpc_cbf_tpu.types import State
    from mpc_cbf_tpu.apps.run_sim import build_sim
    from mpc_cbf_tpu.parallel import make_mesh, sharded_rollout
    from mpc_cbf_tpu.utils.instances import circle_rotate_instance
    from mpc_cbf_tpu.utils import config as cfgmod
    from mpc_cbf_tpu.utils.metrics import instance_success, instance_success_ref

    cfg = copy.deepcopy(cfg)
    if fov is not None:
        cfg.setdefault("fov_cbf_params", {})["beta"] = float(fov)
    if slack_decay is not None:
        cfg.setdefault("cbf_params", {})["slack_decay_rate"] = float(slack_decay)

    sim, mpc = build_sim(cfg, controller, R, solver_iters)
    inst = circle_rotate_instance(R, radius=radius)
    so = np.asarray(inst["tasks"]["so"])
    sf = np.asarray(inst["tasks"]["sf"])

    rng = np.random.default_rng(0)
    so_b = so[None] + np.concatenate(
        [rng.normal(0, start_noise, (seeds, R, 2)), np.zeros((seeds, R, 1))], -1
    )
    init = State(pos=jnp.asarray(so_b, jnp.float32),
                 vel=jnp.zeros((seeds, R, 3), jnp.float32))
    goals = jnp.asarray(np.broadcast_to(sf, (seeds, R, 3)).copy(), jnp.float32)

    if mesh is None:
        mesh = make_mesh(scenario=len(jax.devices()))
    t0 = time.time()
    res = jax.block_until_ready(sharded_rollout(sim, mesh, init, goals, steps))
    wall = time.time() - t0

    shape, shape_type = cfgmod.parse_collision_shape(cfg)
    coll = np.asarray(shape[:2]) if shape_type == "box" else shape
    rows = []
    traj = np.asarray(res.traj_pos)   # [S, T, R, 3]
    for s in range(seeds):
        # dual scoring: strict (collision + goal-reach — this repo's bar)
        # AND the reference's collision-only semantics (its goal-miss
        # return is commented out, collision_check.py:56-59) so grid
        # tables compare apples-to-apples with reference-scored runs
        tr = traj[s].transpose(1, 0, 2)
        ok, makespan = instance_success(
            tr, sf, radius=1.0, collision_shape=coll, shape_type=shape_type)
        ok_ref, makespan_ref = instance_success_ref(
            tr, sf, radius=1.0, collision_shape=coll, shape_type=shape_type)
        # per-seed diagnostics: failure CAUSE is readable from the row
        # (collision vs goal-miss vs solver stall) without re-running
        xy = tr[..., :2]                                   # [R, T, 2]
        dmat = np.linalg.norm(xy[:, None] - xy[None, :], axis=-1)
        iu = np.triu_indices(R, k=1)
        min_sep = float(dmat[iu].min()) if R > 1 else float("inf")
        final_goal_dist = float(np.linalg.norm(
            xy[:, -1] - sf[:, :2], axis=-1).max())
        rows.append({
            "controller": controller, "num_robots": R, "seed": s,
            "fov": float(fov) if fov is not None else None,
            "slack_decay": float(slack_decay) if slack_decay is not None else None,
            "success": bool(ok), "makespan": makespan,
            "success_ref": bool(ok_ref), "makespan_ref": makespan_ref,
            "min_separation": round(min_sep, 3),
            "final_goal_dist_max": round(final_goal_dist, 3),
            "solver_success_rate":
                float(np.asarray(res.success[s], np.float32).mean()),
            "wall_s_batch": round(wall, 2), "steps": steps,
        })
    return (rows, res) if return_result else rows


# backwards-compatible alias (pre-grid name)
run_size = run_cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--base", required=True)
    p.add_argument("--sizes", type=int, nargs="+", default=[2, 4, 6, 8, 10])
    p.add_argument("--seeds", type=int, default=8)
    p.add_argument("--controller", default="connectivity")
    p.add_argument("--fovs", type=float, nargs="+", default=[None],
                   help="FOV beta values in degrees (e.g. 120 240 360)")
    p.add_argument("--slack-decays", type=float, nargs="+", default=[None],
                   help="slack_decay_rate values (e.g. 0.1 0.3)")
    p.add_argument("--radius", type=float, default=4.0,
                   help="instance circle radius (reference fixes 4.0: "
                        "generate_fov_instance.py:89)")
    p.add_argument("--sim-runtime", type=float, default=6.0)
    p.add_argument("--solver-iters", type=int, default=200)
    p.add_argument("--out", default="sweep.jsonl")
    p.add_argument("--platform", default=None)
    args = p.parse_args(argv)

    if args.platform:
        from mpc_cbf_tpu.utils.runtime import force_platform
        force_platform(args.platform)
    from mpc_cbf_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()

    from mpc_cbf_tpu.utils import config as cfgmod
    cfg = cfgmod.load_config(args.base)

    all_rows = []
    for R in args.sizes:
        mpc = cfgmod.parse_mpc_params(cfg)
        steps = int(round(args.sim_runtime / mpc.h))
        for fov in args.fovs:
            for decay in args.slack_decays:
                rows = run_cell(cfg, args.controller, R, args.seeds, steps,
                                args.solver_iters, fov=fov, slack_decay=decay,
                                radius=args.radius)
                all_rows.extend(rows)
                ok = sum(r["success"] for r in rows)
                tag = "".join(
                    [f" fov={fov:g}" if fov is not None else "",
                     f" decay={decay:g}" if decay is not None else ""])
                print(f"R={R}{tag}: {ok}/{len(rows)} success, "
                      f"batch wall {rows[0]['wall_s_batch']}s")

    with open(args.out, "w") as f:
        for r in all_rows:
            f.write(json.dumps(r) + "\n")
    print(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
