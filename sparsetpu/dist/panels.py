"""Sharded SpGEMM with B-panel ring exchange (both operands row-sharded).

dist/shard.py replicates the right operand — the correct call when B is the
small static base matrix of the A^k chain.  When B is itself large (e.g.
squaring a grown product, C = P x P), replication wastes device memory
and interconnect bandwidth; the BASELINE design is instead: every device keeps its *panel*
(its block of B rows), and panels rotate around the mesh ring with
``jax.lax.ppermute`` while each device expands the partial products whose
inner index k falls inside the panel it currently holds.  After n_devices
steps every (A-entry, B-row) pair has met exactly once; one local
sort/compress turns the accumulated streams into the output row block.

The permute of step t+1 and the expansion against panel t are independent
ops in one jit (both read the held panel; neither reads the other's
output), so the compiler may schedule the transfer concurrently with local
compute — the overlap the reference gets from rayon work-stealing
(src/graph_csr.rs:350-484) re-expressed as a collective pipeline.  On GPUs
XLA hands ``ppermute`` to NCCL over NVLink; every card reaches every other
at the same rate, so the ring needs no particular device order.  The
XLA:CPU virtual mesh lowers ppermute to a synchronous
``collective-permute``; whether XLA:GPU overlaps it with the expansion is
not measured yet.

All shapes static: per-step expansion capacity = max over (device, panel)
pairs of the per-panel flop count, from the sharded symbolic pass.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..csr import SparseCSR
from ..ops.segments import INT32_SENTINEL, cumsum_blocked
from ..semiring import by_name
from .shard import AXIS, ShardedCSR, default_mesh


def symbolic_flops_panels(a: ShardedCSR, b: ShardedCSR,
                          mesh: Optional[Mesh] = None) -> jnp.ndarray:
    """flops[d, s] = partial products device d generates against B-panel s.

    The host sizes the static per-step expansion capacity from ``max()``;
    the row sums give each device's total (== symbolic_flops_sharded with a
    replicated B).  One all-gather of B's per-row nnz (int32[n]) — tiny next
    to the value panels themselves."""
    mesh = mesh if mesh is not None else default_mesh(a.n_shards)
    nd = int(np.prod(mesh.devices.shape))
    cap = a.capacity
    nlb = b.n_local

    def local(ci, nnz, b_rp, b_nnz):
        # local B row nnz -> all panels' row nnz via all_gather
        rn_loc = (b_rp[0, 1:] - b_rp[0, :-1])  # int32[nlb]
        rn_all = jax.lax.all_gather(rn_loc, AXIS)  # (nd, nlb)
        valid = jnp.arange(cap) < nnz[0]
        k = jnp.clip(ci[0], 0, nd * nlb - 1)
        panel = k // nlb
        counts = jnp.where(valid, rn_all[panel, k % nlb], 0)
        per_panel = jax.ops.segment_sum(counts, panel, num_segments=nd)
        return per_panel[None]

    f = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
        out_specs=P(AXIS),
    )
    return f(a.col_idx, a.nnz, b.row_ptr, b.nnz)


def _expand_against_panel(sr, a_rows, a_cols, a_vals, valid_a,
                          p_rp, p_ci, p_vals, panel_base, nlb, step_cap,
                          n_rows_local):
    """Partial-product streams for A entries whose column k lies in the
    currently-held B panel [panel_base, panel_base + nlb).  Static shapes:
    returns (i, j, v, valid) of length step_cap (ops/spgemm.py expand, with
    a panel-membership mask)."""
    cap_a = a_cols.shape[0]
    in_panel = valid_a & (a_cols >= panel_base) & (a_cols < panel_base + nlb)
    k_loc = jnp.clip(a_cols - panel_base, 0, nlb - 1)
    row_nnz = p_rp[1:] - p_rp[:-1]
    counts = jnp.where(in_panel, row_nnz[k_loc], 0).astype(jnp.int32)
    cum = cumsum_blocked(counts)
    total = cum[cap_a - 1] if cap_a > 0 else jnp.int32(0)

    t = jnp.arange(step_cap, dtype=jnp.int32)
    from ..ops import segments as segs

    starts = jnp.where(counts > 0, cum - counts, step_cap)
    src = segs.repeat_index(
        starts, jnp.arange(cap_a, dtype=jnp.int32), step_cap
    )
    valid_e = t < total
    src = jnp.clip(src, 0, cap_a - 1)
    # per-entry fused shift (see ops/spgemm.expand_products)
    shift = p_rp[k_loc] - (cum - counts)
    p_pos = jnp.clip(t + shift[src], 0, p_ci.shape[0] - 1)

    i = jnp.where(valid_e, a_rows[src], n_rows_local)
    j = jnp.where(valid_e, p_ci[p_pos], INT32_SENTINEL)
    v = sr.mul(sr.gather(a_vals, src), sr.gather(p_vals, p_pos))
    v = sr.where(valid_e, v, sr.zeros((step_cap,)))
    return i, j, v, valid_e, total


def spgemm_panels(a: ShardedCSR, b: ShardedCSR, step_cap: int,
                  out_cap: Optional[int] = None,
                  mesh: Optional[Mesh] = None) -> ShardedCSR:
    """C = A x B with BOTH operands row-sharded; B panels ride the ring.

    ``step_cap`` >= max over (device, panel) of symbolic_flops_panels;
    ``out_cap`` bounds nnz per output row block (defaults to nd * step_cap,
    the total expansion size)."""
    mesh = mesh if mesh is not None else default_mesh(a.n_shards)
    nd = int(np.prod(mesh.devices.shape))
    assert a.n_shards == nd and b.n_shards == nd
    assert a.n_cols == b.n_rows
    out_cap = out_cap or nd * step_cap
    sr = a.sr
    n_local, nlb = a.n_local, b.n_local
    sr_name = a.sr_name

    def local(rp, ci, vals, nnz, b_rp, b_ci, b_vals, b_nnz):
        my = jax.lax.axis_index(AXIS)
        valid_a = jnp.arange(a.capacity) < nnz[0]
        # local-entry row ids: scatter+cummax (see SparseCSR.row_of_slot)
        from ..ops import segments as segs

        slots = jnp.arange(a.capacity, dtype=jnp.int32)
        a_rows = segs.repeat_index(
            rp[0][:-1], jnp.arange(n_local, dtype=jnp.int32), a.capacity
        )
        a_rows = jnp.where(slots < nnz[0], a_rows, jnp.int32(n_local))
        a_vals = tuple(v[0] for v in vals)
        a_cols = ci[0]

        # rotating panel state (start: own panel).  The ring is a
        # lax.fori_loop, not a Python unroll: one traced expansion instead
        # of nd copies cuts the XLA compile burden ~nd-fold.
        nlimbs = len(b_vals)
        shift = [(d, (d - 1) % nd) for d in range(nd)]

        def ring_step(step, carry):
            (p_rp, p_ci, p_vals, i_all, j_all, ok_all, v_all, total,
             flops_ok) = carry
            src_shard = jnp.mod(my + step, nd)  # whose panel we hold now
            panel_base = src_shard.astype(jnp.int32) * jnp.int32(nlb)
            i, j, v, ok, t = _expand_against_panel(
                sr, a_rows, a_cols, a_vals, valid_a,
                p_rp, p_ci, p_vals, panel_base, nlb, step_cap, n_local,
            )
            off = step * step_cap
            i_all = jax.lax.dynamic_update_slice(i_all, i, (off,))
            j_all = jax.lax.dynamic_update_slice(j_all, j, (off,))
            ok_all = jax.lax.dynamic_update_slice(ok_all, ok, (off,))
            v_all = tuple(
                jax.lax.dynamic_update_slice(buf, limb, (off,))
                for buf, limb in zip(v_all, v)
            )
            total = total + t
            # products are dropped PER ring step when that step's expansion
            # exceeds step_cap, so overflow must be tracked per step — an
            # aggregate total <= nd * step_cap check would let a device
            # with one step over cap and others under it pass silently
            flops_ok = flops_ok & (t <= step_cap)
            # rotate panels: device d's panel goes to d-1, so after `step`
            # rotations device d holds panel (d + step) % nd.  XLA
            # schedules the ppermute concurrently with independent local
            # work; the final rotation completes the cycle (identity).
            p_rp = jax.lax.ppermute(p_rp, AXIS, shift)
            p_ci = jax.lax.ppermute(p_ci, AXIS, shift)
            p_vals = tuple(jax.lax.ppermute(x, AXIS, shift) for x in p_vals)
            return (p_rp, p_ci, p_vals, i_all, j_all, ok_all, v_all, total,
                    flops_ok)

        # fresh buffers are replicated-typed under shard_map; the loop body
        # makes them device-varying, so pre-mark the carry with pvary to
        # keep the fori_loop carry type fixed
        vary = lambda x: jax.lax.pvary(x, AXIS)
        init = (
            b_rp[0], b_ci[0], tuple(v[0] for v in b_vals),
            vary(jnp.full((nd * step_cap,), n_local, jnp.int32)),
            vary(jnp.full((nd * step_cap,), INT32_SENTINEL, jnp.int32)),
            vary(jnp.zeros((nd * step_cap,), bool)),
            tuple(vary(jnp.zeros((nd * step_cap,), b_vals[li].dtype))
                  for li in range(nlimbs)),
            vary(jnp.int32(0)), vary(jnp.bool_(True)),
        )
        (_, _, _, i_all, j_all, ok_all, v_all, total, flops_ok) = (
            jax.lax.fori_loop(0, nd, ring_step, init)
        )
        c = SparseCSR.from_coo_device(
            i_all, j_all, v_all, n_local, b.n_cols, sr, out_cap,
            valid=ok_all,
        )
        # step_cap overflow drops products: poison like ops/spgemm.spgemm
        cnnz = jnp.where(flops_ok, c.nnz, -1).astype(jnp.int32)
        return (
            c.row_ptr[None], c.col_idx[None],
            tuple(x[None] for x in c.values), cnnz[None],
        )

    vspec = tuple(P(AXIS) for _ in a.values)
    f = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), vspec, P(AXIS),
                  P(AXIS), P(AXIS), vspec, P(AXIS)),
        out_specs=(P(AXIS), P(AXIS), vspec, P(AXIS)),
    )
    rp, ci, vals, nnz = f(
        a.row_ptr, a.col_idx, a.values, a.nnz,
        b.row_ptr, b.col_idx, b.values, b.nnz,
    )
    return ShardedCSR(
        row_ptr=rp, col_idx=ci, values=vals, nnz=nnz,
        n_rows=a.n_rows, n_cols=b.n_cols, sr_name=sr_name, n_local=n_local,
    )


def spgemm_panels_auto(a: ShardedCSR, b: ShardedCSR,
                       mesh: Optional[Mesh] = None,
                       round_to_pow2: bool = True) -> ShardedCSR:
    """Two-pass driver: sharded symbolic pass sizes the static per-step
    capacity, then the ring-exchange numeric pass runs."""
    mesh = mesh if mesh is not None else default_mesh(a.n_shards)
    flops = np.asarray(jax.device_get(symbolic_flops_panels(a, b, mesh=mesh)))
    cap = max(int(flops.max()), 1)
    # out_cap: the per-device TOTAL expansion (row sum over panels) bounds
    # that device's output nnz — typically far below the nd*step_cap
    # default, which made the final sort nd times larger than needed
    out_cap = max(int(flops.sum(axis=1).max()), 1)
    if round_to_pow2:
        cap = 1 << (cap - 1).bit_length()
        out_cap = 1 << (out_cap - 1).bit_length()
    return spgemm_panels(a, b, step_cap=cap, out_cap=out_cap, mesh=mesh)
