"""Device mesh construction for multi-chip scaling.

The reference's only parallelism is intra-process OpenMP (SURVEY.md §2);
scale-out here is genuinely new design: a 2-D mesh with a `rays` axis
(pixels/rays data-parallel — the analog of the reference's OMP pixel loops)
and a `blocks` axis (voxel-block storage sharding). Grid storage is
RESIDENT-sharded on the block axis with owner-computes semantics
(`parallel/sharding.py`): each device holds a contiguous shard of block
slots, fusion contributions are merged into the owner via psum_scatter,
and queries gather only the fields they touch — grid state is never
materialized unsharded. Collectives ride NVLink between the GPUs of a
host; `jax.distributed` extends the same mesh across hosts over the
network.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh

RAY_AXIS = "rays"
BLOCK_AXIS = "blocks"


def make_mesh(n_devices: int | None = None, block_parallel: int = 1) -> Mesh:
    """Build a (rays, blocks) mesh over the first n_devices devices.

    block_parallel divides n_devices; the remainder goes to the ray axis.
    """
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    devs = devs[:n]
    assert n % block_parallel == 0, (n, block_parallel)
    arr = np.asarray(devs).reshape(n // block_parallel, block_parallel)
    return Mesh(arr, (RAY_AXIS, BLOCK_AXIS))
