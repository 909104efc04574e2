"""Multi-host execution: jax.distributed initialization + host-spanning
meshes for the row-partitioned SpGEMM chain.

BASELINE config 5 runs the A^7 chain on >= 2 hosts: each host owns a CSR
row block, B panels ride the ring (dist/panels.py) over NVLink within a
host and the network across hosts.  Everything in dist/ is mesh-generic —
shard_map code is identical on 1 device, 1 host, or many hosts — so the
only multi-host-specific pieces are (a) runtime initialization and (b)
building a mesh over all hosts' devices with host-contiguous row blocks.
tests/test_multihost.py runs two processes on virtual CPU devices; a run
across real hosts is not measured yet.

Reference mapping: the reference has no distributed mode at all (rayon
threads are its only parallelism, SURVEY.md §2.6); this is the "new"
capability BASELINE.json names.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

from .shard import AXIS


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Bring up the multi-host runtime (idempotent).

    Nothing is auto-discovered: the coordinator address (any free
    ``host:port``), the process count and this process's id come from the
    arguments or the environment:

        SPARSETPU_COORD=host0:1234 SPARSETPU_NPROC=2 SPARSETPU_PID=0 \
            python bench.py ...
    """
    # NOTE: must not probe jax.process_count() here — it initializes the XLA
    # backend, after which jax.distributed.initialize() refuses to run
    if jax.distributed.is_initialized():
        return  # already initialized
    coordinator_address = coordinator_address or os.environ.get(
        "SPARSETPU_COORD")
    if num_processes is None and "SPARSETPU_NPROC" in os.environ:
        num_processes = int(os.environ["SPARSETPU_NPROC"])
    if process_id is None and "SPARSETPU_PID" in os.environ:
        process_id = int(os.environ["SPARSETPU_PID"])
    if coordinator_address is None and num_processes is None:
        # single-process (possibly multi-chip) — nothing to do
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def pod_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over every device of every host, ordered host-major so a
    row-sharded matrix keeps each host's row block contiguous — ring
    neighbours are on-host (NVLink) except one network hop per host
    boundary, so the panel ring's per-step transfer rides the fast links
    n_local_devices-1 times out of n_local_devices."""
    devices = list(devices if devices is not None else jax.devices())
    devices.sort(key=lambda d: (d.process_index, getattr(d, "id", 0)))
    return Mesh(np.asarray(devices), (AXIS,))


def host_row_block(n_rows: int) -> tuple:
    """(start, stop) of this process's row block under pod_mesh sharding
    (host-major, equal blocks padded to the device count)."""
    nd = jax.device_count()
    per = -(-n_rows // nd)
    local = jax.local_device_count()
    first = jax.process_index() * local
    return (min(first * per, n_rows),
            min((first + local) * per, n_rows))
