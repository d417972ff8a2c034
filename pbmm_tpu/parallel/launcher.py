"""Multi-host launch + distributed initialization.

The reference is strictly single-machine/single-GPU (SURVEY.md §2.5); this
layer is the BASELINE-specified green-field scale-out path:

- one process per host, `jax.distributed.initialize` over the network;
- a ("host", "card") -> flattened ("data", "frame") mesh where the host
  axis only carries independent videos (network traffic = input
  distribution and final gather; all per-video halo exchange stays on the
  host's card-to-card links);
- health: initialization itself is the failure detector (a dead host fails
  the barrier); recovery is driver-level — restart and resume from the
  last `VideoState` checkpoint (`engine/state.py`), which reproduces the
  uninterrupted stream exactly (tests/test_checkpoint.py).

On a single process this degrades to the local mesh — all functions are
usable unconditionally.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import jax

from pbmm_tpu.parallel.mesh import make_mesh, mesh_shape_for


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed from args or env (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID).  Returns True if a multi-process
    setup was initialized, False for single-process operation."""
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if not coordinator_address:
        return False
    num_processes = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    process_id = (
        process_id
        if process_id is not None
        else int(os.environ.get("JAX_PROCESS_ID", "0"))
    )
    if num_processes <= 1:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def global_mesh(n_videos: int = 1):
    """Mesh over ALL devices (across hosts).  Videos shard over "data"
    (host-aligned when possible so a video's frames stay on one host's
    card-to-card links), frames over "frame"."""
    n = jax.device_count()
    return make_mesh(mesh_shape_for(n, n_videos))


def host_local_batch_slice(batch_size: int) -> Tuple[int, int]:
    """[start, end) of the video-batch rows this process should feed
    (inputs are distributed host-locally, then device_put re-shards)."""
    pid = jax.process_index()
    n = jax.process_count()
    per = -(-batch_size // n)
    return pid * per, min((pid + 1) * per, batch_size)
