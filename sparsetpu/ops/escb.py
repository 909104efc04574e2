"""Blocked ESC SpGEMM: row-packed batched-sort formulation, compile-bounded.

The monolithic ESC kernel (ops/spgemm.py) sorts one 1-D stream of every
partial product, whose compile time and runtime grow super-linearly with
the stream on the machine this system was first written for.  This module
keeps the ESC algorithm (expand all partial products, sort,
merge duplicates) but restructures every super-linear-compile op into a
compile-bounded batched form:

  1. *plan* (host): fetch per-row product counts fr (one n-sized transfer,
     the same two-pass role as the reference's symbolic pass,
     src/graph_csr.rs:363-403), then bin-pack whole rows into blocks of
     lane width L (next-fit decreasing — the MAGNUS row-categorization
     idea, src/graph_magnus.rs:225-242 / arXiv:2501.07056, generalized
     from per-row slabs to packed multi-row bins, so padding waste is a
     packing remainder instead of rowcat's pow2 slab padding).
  2. *expand* (device): gather every partial product directly into the
     (nb, L) row-aligned layout — rows never straddle blocks, so all
     later phases are block-local.
  3. *sort* (device): ONE batched ``lax.sort`` along lanes by the fused
     (i*m+j) key — compile- and runtime-bounded by L, unlike the global
     1-D sort.
  4. *merge+assemble* (device): lane-axis segmented saturating scan,
     duplicate/zero drop, per-row survivor ranks, and one index scatter +
     gathers into the output CSR.  All full-stream scans use the
     two-level ``segments.blocked_scan``.

Rows whose product count exceeds L are packed alone into wide blocks of
lane width L2 (a second, rarely-taken program); rows beyond L2 raise.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..csr import SparseCSR
from . import segments
from .segments import INT32_SENTINEL

# default lane width: compile cost of the batched sort / lane scans is
# bounded by L; 2^15 keeps per-block working sets small while amortizing
# per-block overheads
DEFAULT_L = 1 << 15
MAX_L = 1 << 20


def _pow2(x: int) -> int:
    return 1 << (max(int(x), 1) - 1).bit_length()


@jax.jit
def row_flops(a: SparseCSR, b: SparseCSR) -> jnp.ndarray:
    """fr[i] = number of partial products row i of A x B expands to."""
    valid = jnp.arange(a.capacity) < a.nnz
    col = jnp.clip(a.col_idx, 0, b.n_rows - 1)
    counts = jnp.where(valid, b.row_nnz()[col], 0).astype(jnp.int32)
    cin0 = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), segments.cumsum_blocked(counts)]
    )
    return cin0[a.row_ptr[1:]] - cin0[a.row_ptr[:-1]]


def pack_rows(fr: np.ndarray, L: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Next-fit-decreasing bin packing of rows into blocks of capacity L.

    Returns (pack2row, starts_pad, nb): pack order q -> row id, q -> padded
    start position, and the block count.  Rows with fr[r] > L must be
    filtered by the caller."""
    order = np.argsort(-fr, kind="stable")
    pack2row = np.empty(len(fr), np.int32)
    starts_pad = np.empty(len(fr), np.int32)
    q = 0
    block = 0
    used = 0
    for r in order:
        f = int(fr[r])
        if used + f > L:
            block += 1
            used = 0
        pack2row[q] = r
        starts_pad[q] = block * L + used
        used += f
        q += 1
    nb = block + 1
    return pack2row, starts_pad, nb


@partial(jax.jit, static_argnames=("L", "nb", "out_cap", "cap_g", "narrow"))
def _numeric(a: SparseCSR, b: SparseCSR, pack2row: jnp.ndarray,
             starts_pad: jnp.ndarray, fr: jnp.ndarray,
             L: int, nb: int, out_cap: int, cap_g: int,
             narrow: bool = False) -> SparseCSR:
    """Device half: expand into (nb, L), batched sort, lane merge, assemble.

    Output rows not covered by ``pack2row`` (the wide-row path of
    :func:`spgemm_blocked`) get nnz 0 here; the caller merges.

    ``narrow`` (u64, caller-verified max(A)*max(B) < 2^32): the product
    stream rides ONE u32 limb — two fewer full-stream value gathers, one
    fewer sort payload, half the lane-merge planes; the hi limb is
    reconstructed exactly from plane carries (segments._recombine_sat16,
    ops/spgemm.expand_products has the same mode)."""
    sr = a.sr
    n, m = a.n_rows, b.n_cols
    cap_a = a.capacity
    npad = nb * L
    nq = pack2row.shape[0]

    # --- per-slot row resolution: q(s) via scatter + blocked cummax over
    # the padded stream (pack order is ascending along the stream by
    # construction, so cummax propagates the covering q)
    q_of_slot = segments.repeat_index(
        starts_pad, jnp.arange(nq, dtype=jnp.int32), npad
    )
    q_safe = jnp.clip(q_of_slot, 0, nq - 1)
    r = pack2row[q_safe]                      # row id per padded slot
    off_in_row = jnp.arange(npad, dtype=jnp.int32) - starts_pad[q_safe]
    fr_r = fr[r]
    ok = (q_of_slot >= 0) & (off_in_row < fr_r)

    # --- natural-stream machinery (same as ESC expand): per-A-entry
    # product counts, stream->entry map, per-entry b-row shift
    valid_e = jnp.arange(cap_a) < a.nnz
    a_cols = jnp.clip(a.col_idx, 0, b.n_rows - 1)
    counts = jnp.where(valid_e, b.row_nnz()[a_cols], 0).astype(jnp.int32)
    cincl = segments.cumsum_blocked(counts)
    cin0 = jnp.concatenate([jnp.zeros((1,), jnp.int32), cincl])
    # cap_g covers the FULL natural stream (all of A's rows, packed here or
    # not): packed rows may sit after unpacked wide rows in natural order
    starts_g = jnp.where(counts > 0, cincl - counts, cap_g)
    src = segments.repeat_index(
        starts_g, jnp.arange(cap_a, dtype=jnp.int32), cap_g
    )
    shift = b.row_ptr[a_cols] - (cincl - counts)

    # natural-stream position of each padded slot's product
    row_start_g = cin0[a.row_ptr[jnp.clip(r, 0, n - 1)]]
    g = jnp.clip(row_start_g + off_in_row, 0, cap_g - 1)
    e = jnp.clip(src[g], 0, cap_a - 1)
    b_pos = jnp.clip(g + shift[e], 0, b.capacity - 1)

    j = b.col_idx[b_pos]
    key = jnp.where(ok, r * jnp.int32(m) + j, INT32_SENTINEL)
    if narrow:
        assert sr.name == "u64", sr.name
        prod = a.values[0][e] * b.values[0][b_pos]  # < 2^32, exact
        v = (jnp.where(ok, prod, 0),)
    else:
        v = sr.mul(sr.gather(a.values, e), sr.gather(b.values, b_pos))
        v = sr.where(ok, v, sr.zeros((npad,)))

    # --- batched sort along lanes (rows never straddle blocks)
    key2 = key.reshape(nb, L)
    limbs2 = tuple(x.reshape(nb, L) for x in v)
    out = jax.lax.sort([key2, *limbs2], dimension=1, num_keys=1,
                       is_stable=False)
    key_s, limbs_s = out[0], tuple(out[1:])

    # --- lane-axis segmented merge (duplicates adjacent within a block)
    prev = jnp.pad(key_s[:, :-1], ((0, 0), (1, 0)), constant_values=-1)
    head = key_s != prev
    totals, exact_ok = segments.segment_reduce_sorted(sr, head, limbs_s,
                                                      axis=1)
    tail = jnp.concatenate(
        [head[:, 1:], jnp.ones((nb, 1), bool)], axis=1
    )
    keep = tail & (key_s != INT32_SENTINEL) & ~sr.is_zero(totals)

    # --- assemble: per-survivor rank within its row, then one index
    # scatter + gathers (ops/segments.compact's trick, row-targeted)
    keyf = key_s.reshape(npad)
    keepf = keep.reshape(npad)
    totf = tuple(x.reshape(npad) for x in totals)
    rowf = jnp.where(keyf != INT32_SENTINEL, keyf // jnp.int32(m), n)
    excl = segments.cumsum_blocked(keepf.astype(jnp.int32)) \
        - keepf.astype(jnp.int32)
    # E at each row's head, broadcast over the row: lane segmented cummax
    # of (row head ? excl : -1); row heads = key-row changes (block-local)
    prev_row = jnp.pad(rowf.reshape(nb, L)[:, :-1], ((0, 0), (1, 0)),
                       constant_values=-1)
    row_head = rowf.reshape(nb, L) != prev_row
    e_at_head = jnp.where(row_head, excl.reshape(nb, L), -1)
    # native cummax, not associative_scan: the latter composed with the
    # surrounding reshapes stalled the compiler of the machine this system
    # was first written for
    e_head = jax.lax.cummax(e_at_head, axis=1)
    rank = excl - e_head.reshape(npad)

    # per-row survivor counts: scatter-add keep by row
    nr = jnp.zeros((n,), jnp.int32).at[jnp.clip(rowf, 0, n)].add(
        keepf.astype(jnp.int32), mode="drop")
    row_ptr = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), segments.cumsum_blocked(nr)]
    ).astype(jnp.int32)
    nnz = row_ptr[-1]

    dest = jnp.where(keepf, row_ptr[jnp.clip(rowf, 0, n - 1)] + rank,
                     out_cap)
    src_of_dest = jnp.full((out_cap,), npad, jnp.int32)
    src_of_dest = src_of_dest.at[dest].set(
        jnp.arange(npad, dtype=jnp.int32), mode="drop")
    sod = jnp.clip(src_of_dest, 0, npad - 1)
    filled = src_of_dest < npad
    col_idx = jnp.where(filled, keyf[sod] % jnp.int32(m), INT32_SENTINEL)
    vals = tuple(jnp.where(filled, x[sod], 0) for x in totf)
    nnz_out = jnp.where((nnz <= out_cap) & exact_ok, nnz, -1).astype(jnp.int32)
    return SparseCSR(
        row_ptr=row_ptr, col_idx=col_idx, values=vals, nnz=nnz_out,
        n_rows=n, n_cols=m, sr_name=sr.name,
    )


def spgemm_blocked(a: SparseCSR, b: SparseCSR,
                   out_cap: Optional[int] = None,
                   L: int = DEFAULT_L) -> SparseCSR:
    """C = A x B via row-packed blocked ESC.  Host involvement: one n-sized
    fr fetch + the bin packing; then one fused numeric dispatch (two when
    wide rows force a second lane width)."""
    assert a.n_cols == b.n_rows, (a.shape, b.shape)
    if a.n_rows * b.n_cols >= 1 << 31:
        # the fused i*m+j key wraps int32: merges/rows silently corrupt.
        # ops/slab.py sorts on (row, col) pairs and has no such bound.
        raise ValueError(
            f"escb fused keys need n*m < 2^31 (got {a.n_rows}x{b.n_cols}); "
            "use ops/slab.spgemm_slab")
    from .spgemm import narrow_u64_ok

    narrow = narrow_u64_ok(a, b)
    fr_dev = row_flops(a, b)
    fr = np.asarray(jax.device_get(fr_dev)).astype(np.int64)
    total = int(fr.sum())
    if total >= 1 << 31:
        raise ValueError(
            f"expansion of {total} products cannot be materialized")
    cap = out_cap or _pow2(max(total, 1))
    cap_g = _pow2(max(total, 1))

    wide = fr > L
    L2 = 0
    if wide.any():
        wmax = int(fr[wide].max())
        if wmax > MAX_L:
            raise ValueError(
                f"row expands to {wmax} products (> {MAX_L}); use a "
                "dense-accumulator path for this product")
        L2 = _pow2(wmax)

    def run(rows_mask, lane):
        fr_m = np.where(rows_mask, fr, 0)
        sel = np.flatnonzero(fr_m > 0)
        if len(sel) == 0:
            return None
        frs = fr_m[sel]
        p2r, st, nb = pack_rows(frs, lane)
        pack2row = sel[p2r].astype(np.int32)
        return _numeric(
            a, b, jnp.asarray(pack2row), jnp.asarray(st),
            jnp.asarray(fr.astype(np.int32)), lane, nb, cap, cap_g,
            narrow=narrow,
        )

    narrow_res = run(~wide, L)
    wide_res = run(wide, L2) if L2 else None
    if narrow_res is None and wide_res is None:
        return SparseCSR.empty(a.n_rows, b.n_cols, max(cap, 1), a.sr)
    if wide_res is None:
        return narrow_res
    if narrow_res is None:
        return wide_res
    return merge_disjoint_rows(narrow_res, wide_res, cap)


@partial(jax.jit, static_argnames=("out_cap",))
def merge_disjoint_rows(c1: SparseCSR, c2: SparseCSR,
                        out_cap: int) -> SparseCSR:
    """Merge two CSRs with disjoint row supports: per-row counts add, then
    one arithmetic gather per array — no sort (spadd's COO re-sort would
    reintroduce the 1-D-sort ceiling at chain scales)."""
    assert c1.shape == c2.shape
    n = c1.n_rows
    nr1 = c1.row_nnz()
    nr2 = c2.row_nnz()
    row_ptr = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32),
         segments.cumsum_blocked((nr1 + nr2).astype(jnp.int32))]
    ).astype(jnp.int32)
    nnz = row_ptr[-1]
    t = jnp.arange(out_cap, dtype=jnp.int32)
    rr = segments.repeat_index(
        row_ptr[:-1], jnp.arange(n, dtype=jnp.int32), out_cap
    )
    rs = jnp.clip(rr, 0, n - 1)
    k = t - row_ptr[rs]
    use1 = nr1[rs] > 0
    pos1 = jnp.clip(c1.row_ptr[rs] + k, 0, c1.capacity - 1)
    pos2 = jnp.clip(c2.row_ptr[rs] + k, 0, c2.capacity - 1)
    in_range = t < nnz
    col_idx = jnp.where(
        in_range,
        jnp.where(use1, c1.col_idx[pos1], c2.col_idx[pos2]),
        INT32_SENTINEL,
    )
    vals = tuple(
        jnp.where(in_range, jnp.where(use1, v1[pos1], v2[pos2]), 0)
        for v1, v2 in zip(c1.values, c2.values)
    )
    poisoned = (c1.nnz < 0) | (c2.nnz < 0) | (nnz > out_cap)
    nnz_out = jnp.where(poisoned, -1, nnz).astype(jnp.int32)
    return SparseCSR(
        row_ptr=row_ptr, col_idx=col_idx, values=vals, nnz=nnz_out,
        n_rows=n, n_cols=c1.n_cols, sr_name=c1.sr_name,
    )
