"""Worker process for test_distributed_multiprocess.py.

Runs one jax.distributed CPU process (4 virtual devices) of an N-process
cluster, feeds its host-local scenarios through host_scenarios_to_global
+ sharded_rollout, and dumps its addressable shards (with their global
scenario offsets) to an npz for the parent to reassemble.

Usage: python distributed_worker.py <pid> <nproc> <port> <out.npz>
"""
import os
import sys

pid, nproc, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]

os.environ["JAX_PLATFORMS"] = "cpu"
# FORCE 4 virtual devices per process (the parent pytest env exports 8 —
# strip any inherited count so the 2-process mesh is exactly 8 wide)
flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
         if "host_platform_device_count" not in f]
os.environ["XLA_FLAGS"] = " ".join(
    flags + ["--xla_force_host_platform_device_count=4"])

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

jax.distributed.initialize(f"localhost:{port}", num_processes=nproc,
                           process_id=pid)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mpc_cbf_tpu.types import State  # noqa: E402
from mpc_cbf_tpu.ops.cbf import ConnectivityCBF  # noqa: E402
from mpc_cbf_tpu.ops.qp import ADMMConfig  # noqa: E402
from mpc_cbf_tpu.controllers import (  # noqa: E402
    BezierParams, MPCParams, BezierMPCOperator, IMPCParams, ConnectivityIMPCCBF,
)
from mpc_cbf_tpu.parallel import MultiAgentSim, sharded_rollout  # noqa: E402
from mpc_cbf_tpu.parallel.distributed import (  # noqa: E402
    global_mesh, host_scenarios_to_global,
)


def scenarios(lo, hi):
    """Deterministic scenario set indexed globally (same fn on any host)."""
    starts, goals = [], []
    for s in range(lo, hi):
        off = 0.1 * s
        starts.append([[-1.5, off, 0.0], [1.5, -off, 0.0]])
        goals.append([[1.5, 0.0, 0.0], [-1.5, 0.0, 0.0]])
    return (np.asarray(starts, np.float64), np.asarray(goals, np.float64))


S_PER_HOST = 4
STEPS = 5

mpc = MPCParams()
op = BezierMPCOperator(BezierParams(), mpc, dim=3)
cbf = ConnectivityCBF(0.8, 4.0, jnp.asarray(mpc.v_min), jnp.asarray(mpc.v_max))
ctrl = ConnectivityIMPCCBF(op, cbf, IMPCParams(), 1,
                           solver=ADMMConfig(iters=100))
sim = MultiAgentSim(ctrl, 2)

mesh = global_mesh(agent=1)
lo = pid * S_PER_HOST
starts_l, goals_l = scenarios(lo, lo + S_PER_HOST)
init_g, goals_g = host_scenarios_to_global(
    mesh, (State(pos=jnp.asarray(starts_l), vel=jnp.zeros_like(jnp.asarray(starts_l))),
           jnp.asarray(goals_l)))

res = sharded_rollout(sim, mesh, init_g, goals_g, STEPS)

# dump the locally-addressable scenario shards with their global offsets
tp = res.traj_pos  # [S_global, T, A, 3]
offs, datas = [], []
for sh in tp.addressable_shards:
    offs.append(sh.index[0].start or 0)
    datas.append(np.asarray(sh.data))
np.savez(out, offsets=np.asarray(offs),
         data=np.concatenate([d for d in datas], axis=0),
         sizes=np.asarray([d.shape[0] for d in datas]))
print(f"worker {pid}: wrote {out}", flush=True)
