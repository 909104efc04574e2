"""Sharded block-band chain: block rows partitioned over the row mesh.

The band matmul C[I, dp+da] += P[I, dp] @ A[(I+dp-Wbp) mod nb, da]
(kernels/bandmm.py) only reads A's block rows — with A replicated, every
output block row is computed entirely from local P data, so the sharded
kernel is one shard_map with the global block-row offset threaded through
``row_offset``.  Accumulation order per output element is identical to the
single-device kernel, so results are bit-exact across shardings (the
reference's matmul_par == matmul contract, linalg/src/csr.rs:974-988).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..kernels.bandmm import BandMatrix, _band_matmul_data, fold_cyclic
from .shard import AXIS, default_mesh


def shard_band(b: BandMatrix, mesh: Optional[Mesh] = None) -> BandMatrix:
    """Shard a BandMatrix's block rows over the mesh (data axis 0)."""
    mesh = mesh if mesh is not None else default_mesh(jax.device_count())
    nd = int(np.prod(mesh.devices.shape))
    assert b.nb % nd == 0, f"block rows {b.nb} not divisible by {nd} devices"
    sh = NamedSharding(mesh, P(AXIS))
    return dataclasses.replace(b, data=jax.device_put(b.data, sh))


def replicate_band(b: BandMatrix, mesh: Optional[Mesh] = None) -> BandMatrix:
    """Replicate a BandMatrix on every mesh device (the static right operand)."""
    mesh = mesh if mesh is not None else default_mesh(jax.device_count())
    rep = NamedSharding(mesh, P())
    return dataclasses.replace(b, data=jax.device_put(b.data, rep))


def band_matmul_sharded(p: BandMatrix, a: BandMatrix, p_limbs: int = 0,
                        a_limbs: int = 0,
                        mesh: Optional[Mesh] = None) -> BandMatrix:
    """C = P x A with P's block rows sharded and A replicated; C stays
    sharded.  Mirrors kernels.bandmm.band_matmul (incl. the cyclic fold)."""
    assert p.block == a.block and p.cyclic == a.cyclic and p.n == a.n
    mesh = mesh if mesh is not None else default_mesh(jax.device_count())
    nd = int(np.prod(mesh.devices.shape))
    nb = p.nb
    assert nb % nd == 0, f"block rows {nb} not divisible by {nd} devices"
    nb_local = nb // nd
    wbp, wba, cyclic = p.half_width_blocks, a.half_width_blocks, p.cyclic
    wbc = wbp + wba
    kbc = p.k_blocks + a.k_blocks - 1
    fold = cyclic and kbc > nb

    def local(p_loc, a_full):
        base = jax.lax.axis_index(AXIS) * nb_local
        c = _band_matmul_data(
            p_loc, a_full, wbp, wba, cyclic,
            p_limbs=p_limbs, a_limbs=a_limbs, row_offset=base,
        )
        if fold:
            c = fold_cyclic(c, wbc, nb)
        return c

    f = jax.shard_map(
        local, mesh=mesh, in_specs=(P(AXIS), P()), out_specs=P(AXIS)
    )
    c_data = f(p.data, a.data)
    if fold:
        return BandMatrix(c_data, p.n, p.block, 0, True)
    return BandMatrix(c_data, p.n, p.block, wbc, p.cyclic)
