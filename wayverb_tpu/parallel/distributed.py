"""Multi-host execution: jax.distributed initialization + global meshes.

The reference is single-process, single-device (SURVEY §2.6); scaling the
waveguide past one host needs multi-process SPMD: every host runs the same
jitted program over a GLOBAL device mesh, XLA routes the x-axis halo
ppermutes over ICI within a slice and DCN between hosts.

Usage (one process per host):

    from wayverb_tpu.parallel import distributed as dist
    dist.initialize(coordinator, num_processes, process_id)
    mesh = dist.global_device_mesh()
    out = box_sharded.run_waveguide_box_sharded(mesh, ...)   # SPMD

``run_waveguide_box_sharded`` is multi-host-clean by construction: its
shard_map inputs are replicated host-local arrays (coefficients, source /
receiver taps), every field/plane array is created INSIDE the shard_map
body, and its outputs are replicated scalars/traces — no host ever needs a
device-sharded global array in host memory.

Tested with multi-process CPU (two processes × four virtual devices) in
tests/test_multihost.py — the same code path a v5p pod slice uses.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids=None) -> None:
    """jax.distributed.initialize with pass-through defaults (on a cluster
    that JAX knows, all three parameters come from the environment; on
    one GPU host pass ``coordinator_address`` = ``localhost:<port>``,
    ``num_processes`` and ``process_id``)."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)


def global_device_mesh(axis_name: str = "x") -> Mesh:
    """1-D mesh over every device of every process (global SPMD axis)."""
    return Mesh(np.asarray(jax.devices()), (axis_name,))


def process_count() -> int:
    return jax.process_count()


def is_coordinator() -> bool:
    return jax.process_index() == 0
