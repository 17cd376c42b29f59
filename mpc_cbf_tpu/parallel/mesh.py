"""Device-mesh helpers.

The reference has no distributed runtime at all — scale-out is bash loops
launching independent processes (``experiments/bash/ScaleScript.sh:16-35``).
Here scale is a first-class sharded axis pair:

- ``scenario`` (data axis): embarrassingly parallel Monte-Carlo / sweep
  instances. Scenarios never talk to each other, so this axis needs no
  collective at all and can span cards and hosts.
- ``agent`` (model axis): robots within one scenario. Inter-agent coupling
  (neighbor states, Laplacian assembly) needs collectives along it.

The cards of one host are joined all to all (NVLink), so the mesh shape
follows the algorithm alone: put every card on the scenario axis unless
one scenario is too large for a card.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


SCENARIO_AXIS = "scenario"
AGENT_AXIS = "agent"


def make_mesh(scenario: Optional[int] = None, agent: int = 1,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Mesh over (scenario, agent). Default: all devices on the scenario
    axis (the near-linear-scaling configuration)."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if scenario is None:
        scenario = n // agent
    if scenario * agent != n:
        raise ValueError(f"{scenario}x{agent} mesh needs {scenario*agent} devices, have {n}")
    arr = np.asarray(devices).reshape(scenario, agent)
    return Mesh(arr, (SCENARIO_AXIS, AGENT_AXIS))


def scenario_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis sharding over scenarios, replicated over agents."""
    return NamedSharding(mesh, P(SCENARIO_AXIS))


def scenario_agent_sharding(mesh: Mesh) -> NamedSharding:
    """[S, A, ...] arrays sharded over both mesh axes."""
    return NamedSharding(mesh, P(SCENARIO_AXIS, AGENT_AXIS))
