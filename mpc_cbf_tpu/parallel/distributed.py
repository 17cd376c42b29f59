"""Multi-process runtime helpers (SURVEY §5.8 — absent in the reference).

The scaling recipe: one global mesh {scenario=total_devices/agent_dim,
agent=agent_dim}, scenario-major. The scenario axis is embarrassingly
parallel and may span processes and hosts; every cross-agent reduction
(neighbor gathers, lambda2 assembly) happens inside one scenario shard,
so collectives stay within the devices that share an agent group.

Usage in each process:
    init_distributed(coordinator, n, id)     # e.g. "localhost:<port>"
    mesh = global_mesh(agent=1)
    # process-local scenario data -> global array:
    batch = host_scenarios_to_global(mesh, local_init)
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mpc_cbf_tpu.parallel.mesh import SCENARIO_AXIS, AGENT_AXIS


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize. Pass the coordinator address, process
    count and id explicitly unless the cluster environment provides them.
    Safe to call when already initialized or single-process."""
    try:
        if coordinator_address is None:
            jax.distributed.initialize()
        else:
            jax.distributed.initialize(coordinator_address,
                                       num_processes=num_processes,
                                       process_id=process_id)
    except (RuntimeError, ValueError):
        # already initialized, or single-process context without cluster env
        pass


def global_mesh(agent: int = 1) -> Mesh:
    """Mesh over ALL devices (every process's cards), scenario-major: each
    process's devices land on the scenario axis, which needs no
    collectives, and an agent group stays within one process."""
    devs = np.asarray(jax.devices())
    if devs.size % agent:
        raise ValueError(f"{devs.size} devices not divisible by agent={agent}")
    return Mesh(devs.reshape(devs.size // agent, agent),
                (SCENARIO_AXIS, AGENT_AXIS))


def host_scenarios_to_global(mesh: Mesh, local_batch):
    """Assemble a process-local scenario batch into a global array sharded
    over the mesh's scenario axis (each host contributes its own
    scenarios — the multi-host data-loading pattern).

    local_batch: pytree of [S_local, ...] arrays, same S_local on every
    host. Returns pytree of global arrays with S_global = S_local * hosts.
    """
    sharding = NamedSharding(mesh, P(SCENARIO_AXIS))

    def to_global(x):
        global_shape = (x.shape[0] * jax.process_count(),) + x.shape[1:]
        return jax.make_array_from_process_local_data(
            sharding, np.asarray(x), global_shape)

    return jax.tree.map(to_global, local_batch)
