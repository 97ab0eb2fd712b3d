"""Multi-host initialization (jax.distributed) + mesh spanning hosts.

The reference has no distributed execution at all (SURVEY.md §2); this is
the new scale-out entry point: call `init()` once per host process (driven
by launcher env vars or explicit args), then `global_mesh()` builds the
(rays, blocks) mesh over all global devices — intra-host collectives ride
NVLink, cross-host traffic the network.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

from .mesh import make_mesh


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None):
    """Initialize jax.distributed from args or standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).
    No-op for single-process runs."""
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if coordinator_address is None:
        return False
    num_processes = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("JAX_PROCESS_ID", "0")
    )
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def global_mesh(block_parallel: Optional[int] = None):
    """(rays, blocks) mesh over all global devices; by default the block
    axis spans processes (grid storage sharded across hosts) and the ray
    axis spans the devices within each host."""
    n = len(jax.devices())
    if block_parallel is None:
        block_parallel = max(1, jax.process_count())
    return make_mesh(n, block_parallel=block_parallel)
