"""Multi-host orchestration (SURVEY.md §2b "Multi-host orchestration").

The reference has nothing to orchestrate; here one JAX process per host
joins a global mesh over every card of every host. The 65k-agent
configuration of BASELINE.json is this module + ``make_sharded_step``
with a mesh whose ``agents`` axis spans hosts. Cards inside a host are
joined by NVLink, hosts by the network, so the ``beams`` axis — whose
collectives run every step (TTC psum, gradient psum) — is carved from
the cards of one host, and only the ``agents`` axis crosses hosts
(``make_pod_mesh`` lays devices out that way).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
from jax.sharding import Mesh

_initialized = False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """``jax.distributed.initialize`` wrapper, idempotent.

    Called with no arguments it tries the launcher's environment (e.g. a
    cluster scheduler's variables) and quietly stays single-process when
    there is none — tests and one-host runs need no setup. Called with
    explicit arguments, a failure to join the cluster raises: the caller
    asked for a cluster, and running on alone would be a silent
    misconfiguration.
    """
    global _initialized
    if _initialized or jax.process_count() > 1:
        _initialized = True
        return
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    try:
        jax.distributed.initialize(coordinator_address, num_processes,
                                   process_id)
        _initialized = True
    except Exception:
        if explicit:
            raise
        _initialized = False


def make_pod_mesh(beams_axis: int = 1) -> Mesh:
    """Global mesh over every device of every process.

    Device order groups each host's local devices contiguously, and the
    ``beams`` axis is carved from *local* devices so the per-step
    beam-wedge collectives (TTC psum, gradient psum) stay on the host's
    NVLink instead of the network between hosts.
    """
    procs = jax.process_count()
    local = jax.local_device_count()
    if beams_axis > local or local % beams_axis:
        raise ValueError(
            f"beams_axis={beams_axis} must divide local devices {local} "
            "(keeps beam collectives inside one host)")
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    arr = np.asarray(devs).reshape(procs * (local // beams_axis),
                                   beams_axis)
    return Mesh(arr, ("agents", "beams"))


def global_agent_count(per_device_agents: int, mesh: Mesh) -> int:
    return per_device_agents * mesh.shape["agents"]
