"""Row-partitioned multi-chip execution (jax.sharding / shard_map).

The reference's only parallelism is rayon shared-memory row-parallel SpGEMM
(src/graph_csr.rs:350-484); the multi-device replacement partitions CSR row
blocks across a 1-D device mesh, replicates the (small, static) right
operand, and runs the local kernel per shard — the data-parallel analog of
the reference's disjoint-row-slice writes, with collectives replacing the
shared address space.

Modules:
  - :mod:`sparsetpu.dist.shard` — ShardedCSR + sharded ESC SpGEMM chain.
  - :mod:`sparsetpu.dist.band`  — sharded block-band chain.
"""

from . import band, shard
from .shard import (
    ShardedCSR,
    default_mesh,
    shard as shard_csr,
    spgemm_sharded,
    symbolic_flops_sharded,
    unshard,
)

__all__ = [
    "ShardedCSR",
    "band",
    "default_mesh",
    "shard",
    "shard_csr",
    "spgemm_sharded",
    "symbolic_flops_sharded",
    "unshard",
]
