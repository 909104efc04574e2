"""Row-partitioned CSR over a 1-D device mesh + sharded ESC SpGEMM.

Design (multi-device replacement for the reference's rayon two-pass row-parallel
SpGEMM, src/graph_csr.rs:350-484): the left operand's rows are split into
``n_devices`` contiguous blocks, one per mesh device; each shard stores a
*local* CSR (local row_ptr, column indices still global).  The right operand
is replicated — for the A^k chain the base matrix A is small and static, so
this is one broadcast, and the growing product stays sharded in place across
chain steps (the BASELINE.json requirement).  The numeric step is a single
``shard_map``: every device runs the same static-shape ESC kernel on its row
block, no cross-device traffic during compute.

The symbolic pass (`symbolic_flops_sharded`) returns the per-shard flop count;
the host sizes one uniform static ``expand_cap`` from its max — the analog of
the reference's per-row nnz count + prefix-sum sizing pass.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..csr import SparseCSR
from ..ops.segments import INT32_SENTINEL
from ..ops.spgemm import spgemm
from ..semiring import Value, by_name

AXIS = "row"


def default_mesh(n_devices: int) -> Mesh:
    """1-D mesh over the first n_devices devices, axis name "row"."""
    devs = jax.devices()[:n_devices]
    assert len(devs) == n_devices, f"need {n_devices} devices, have {len(devs)}"
    return Mesh(np.asarray(devs), (AXIS,))


@dataclasses.dataclass(frozen=True)
class ShardedCSR:
    """CSR row-partitioned into nd equal blocks (last block zero-padded).

    row_ptr[d] holds *local* offsets into shard d's entry arrays; col_idx is
    global.  Rows d*n_local + r with global index >= n_rows are empty padding.
    """

    row_ptr: jnp.ndarray  # int32[nd, n_local + 1], sharded over axis 0
    col_idx: jnp.ndarray  # int32[nd, cap_local]
    values: Value         # tuple of sr.nlimbs arrays [nd, cap_local]
    nnz: jnp.ndarray      # int32[nd]
    n_rows: int           # global (unpadded)
    n_cols: int
    sr_name: str
    n_local: int          # rows per shard

    @property
    def sr(self):
        return by_name(self.sr_name)

    @property
    def n_shards(self) -> int:
        return self.row_ptr.shape[0]

    @property
    def capacity(self) -> int:
        return self.col_idx.shape[1]

    def total_nnz(self) -> jnp.ndarray:
        return jnp.sum(self.nnz)

    def memory_bytes(self) -> int:
        limb_bytes = sum(l.dtype.itemsize for l in self.values)
        return int(self.row_ptr.size * 4 + self.col_idx.size * (4 + limb_bytes))


jax.tree_util.register_dataclass(
    ShardedCSR,
    data_fields=["row_ptr", "col_idx", "values", "nnz"],
    meta_fields=["n_rows", "n_cols", "sr_name", "n_local"],
)


def shard(a: SparseCSR, n_devices: int, mesh: Optional[Mesh] = None,
          capacity: Optional[int] = None) -> ShardedCSR:
    """Host-side split of a CSR matrix into nd row blocks, device_put sharded.

    Shards get a uniform static local capacity (max block nnz, or
    ``capacity``); tail blocks past n_rows are empty.
    """
    mesh = mesh if mesh is not None else default_mesh(n_devices)
    n = a.n_rows
    n_local = -(-n // n_devices)
    nnz = int(a.nnz)
    if nnz < 0:
        raise ValueError("cannot shard a capacity-poisoned SparseCSR")
    row_ptr = np.asarray(jax.device_get(a.row_ptr)).astype(np.int64)
    col_idx = np.asarray(jax.device_get(a.col_idx))[:nnz]
    limbs = [np.asarray(jax.device_get(l))[:nnz] for l in a.values]

    starts = [int(row_ptr[min(d * n_local, n)]) for d in range(n_devices + 1)]
    counts = [starts[d + 1] - starts[d] for d in range(n_devices)]
    cap = capacity or max(max(counts), 1)
    assert cap >= max(counts), f"capacity {cap} < max block nnz {max(counts)}"

    rp = np.zeros((n_devices, n_local + 1), np.int32)
    ci = np.full((n_devices, cap), INT32_SENTINEL, np.int32)
    vs = [np.zeros((n_devices, cap), np.asarray(l).dtype) for l in limbs]
    for d in range(n_devices):
        r0, r1 = min(d * n_local, n), min((d + 1) * n_local, n)
        loc = row_ptr[r0:r1 + 1] - row_ptr[r0]
        rp[d, : r1 - r0 + 1] = loc
        rp[d, r1 - r0 + 1:] = loc[-1]
        s, c = starts[d], counts[d]
        ci[d, :c] = col_idx[s:s + c]
        for li, l in enumerate(limbs):
            vs[li][d, :c] = l[s:s + c]

    sh = NamedSharding(mesh, P(AXIS))
    return ShardedCSR(
        row_ptr=jax.device_put(jnp.asarray(rp), sh),
        col_idx=jax.device_put(jnp.asarray(ci), sh),
        values=tuple(jax.device_put(jnp.asarray(v), sh) for v in vs),
        nnz=jax.device_put(jnp.asarray(counts, dtype=jnp.int32), sh),
        n_rows=n,
        n_cols=a.n_cols,
        sr_name=a.sr_name,
        n_local=n_local,
    )


def unshard(s: ShardedCSR) -> SparseCSR:
    """Host-side gather of all shards back into one SparseCSR (tests/export)."""
    sr = s.sr
    rp = np.asarray(jax.device_get(s.row_ptr))
    ci = np.asarray(jax.device_get(s.col_idx))
    limbs = [np.asarray(jax.device_get(l)) for l in s.values]
    nnz = np.asarray(jax.device_get(s.nnz))
    if (nnz < 0).any():
        raise ValueError(
            "ShardedCSR capacity overflow on shard(s) "
            f"{np.nonzero(nnz < 0)[0].tolist()} (nnz poisoned to -1)"
        )
    rows_l, cols_l = [], []
    val_l: list = [[] for _ in limbs]
    for d in range(s.n_shards):
        k = int(nnz[d])
        lr = np.repeat(np.arange(s.n_local, dtype=np.int64), np.diff(rp[d]))[:k]
        rows_l.append(d * s.n_local + lr)
        cols_l.append(ci[d, :k].astype(np.int64))
        for li in range(len(limbs)):
            val_l[li].append(limbs[li][d, :k])
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = sr.to_numpy(tuple(np.concatenate(v) for v in val_l))
    return SparseCSR.from_coo(
        rows, cols, vals, s.n_rows, s.n_cols, sr=sr, capacity=max(len(rows), 1)
    )


from functools import partial


@partial(jax.jit, static_argnames=("mesh", "n_rows_b"))
def _symbolic_flops_impl(col_idx, nnz, b_row_nnz, *, mesh, n_rows_b):
    cap = col_idx.shape[1]

    def local(ci, nz, brn):
        valid = jnp.arange(cap) < nz[0]
        col = jnp.clip(ci[0], 0, n_rows_b - 1)
        return jnp.sum(jnp.where(valid, brn[col], 0))[None]

    f = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P()),
        out_specs=P(AXIS),
    )
    return f(col_idx, nnz, b_row_nnz)


def symbolic_flops_sharded(s: ShardedCSR, b: SparseCSR,
                           mesh: Optional[Mesh] = None) -> jnp.ndarray:
    """Per-shard partial-product counts for S x B — int32[nd], sharded.

    The host sizes the numeric pass's uniform expand_cap from ``max()`` of
    this (the sharded analog of the reference symbolic pass + prefix sums,
    src/graph_csr.rs:363-417).  jit-cached per (mesh, shapes) so chain
    steps don't retrace."""
    mesh = mesh if mesh is not None else default_mesh(s.n_shards)
    return _symbolic_flops_impl(
        s.col_idx, s.nnz, b.row_nnz(), mesh=mesh, n_rows_b=b.n_rows
    )


@partial(jax.jit, static_argnames=(
    "mesh", "expand_cap", "out_cap", "n_local", "n_cols", "sr_name",
    "bn_rows", "bn_cols", "b_sr_name",
))
def _spgemm_sharded_impl(s_rp, s_ci, s_vals, s_nnz, b_rp, b_ci, b_vals,
                         b_nnz, *, mesh, expand_cap, out_cap, n_local,
                         n_cols, sr_name, bn_rows, bn_cols, b_sr_name):
    def local(rp, ci, vals, nnz, brp, bci, bvals, bnnz):
        a_loc = SparseCSR(
            row_ptr=rp[0], col_idx=ci[0],
            values=tuple(v[0] for v in vals), nnz=nnz[0],
            n_rows=n_local, n_cols=n_cols, sr_name=sr_name,
        )
        b_loc = SparseCSR(
            row_ptr=brp, col_idx=bci, values=bvals, nnz=bnnz,
            n_rows=bn_rows, n_cols=bn_cols, sr_name=b_sr_name,
        )
        c = spgemm(a_loc, b_loc, expand_cap, out_cap)
        return (
            c.row_ptr[None], c.col_idx[None],
            tuple(v[None] for v in c.values), c.nnz[None],
        )

    vspec = tuple(P(AXIS) for _ in s_vals)
    bvspec = tuple(P() for _ in b_vals)
    f = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), vspec, P(AXIS), P(), P(), bvspec, P()),
        out_specs=(P(AXIS), P(AXIS), vspec, P(AXIS)),
    )
    return f(s_rp, s_ci, s_vals, s_nnz, b_rp, b_ci, b_vals, b_nnz)


def spgemm_sharded(s: ShardedCSR, b: SparseCSR, expand_cap: int,
                   out_cap: Optional[int] = None,
                   mesh: Optional[Mesh] = None) -> ShardedCSR:
    """C = S x B with S row-sharded and B replicated; C stays row-sharded.

    One shard_map launch: every device runs the static-shape ESC kernel
    (ops/spgemm.py) on its row block with the same ``expand_cap`` (>= the max
    per-shard symbolic flop count).  Zero cross-device traffic during the
    numeric phase — the chain driver calls this repeatedly with the product
    staying sharded in place; the launch is jit-cached per
    (mesh, capacities, shapes) so repeated steps don't retrace."""
    mesh = mesh if mesh is not None else default_mesh(s.n_shards)
    out_cap = out_cap or expand_cap
    assert s.n_cols == b.n_rows, (s.n_rows, s.n_cols, b.shape)
    rp, ci, vals, nnz = _spgemm_sharded_impl(
        s.row_ptr, s.col_idx, s.values, s.nnz,
        b.row_ptr, b.col_idx, b.values, b.nnz,
        mesh=mesh, expand_cap=expand_cap, out_cap=out_cap,
        n_local=s.n_local, n_cols=s.n_cols, sr_name=s.sr_name,
        bn_rows=b.n_rows, bn_cols=b.n_cols, b_sr_name=b.sr_name,
    )
    return ShardedCSR(
        row_ptr=rp, col_idx=ci, values=vals, nnz=nnz,
        n_rows=s.n_rows, n_cols=b.n_cols, sr_name=s.sr_name,
        n_local=s.n_local,
    )
