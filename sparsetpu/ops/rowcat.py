"""Row-categorized SpGEMM: the MAGNUS numeric phase, vectorized.

The reference delegates to the ICS'25 MAGNUS kernel whose core idea is
*categorize rows by accumulator size, then run a specialized kernel per
category* (src/graph_magnus.rs:225-242, arXiv:2501.07056).  A plain ESC
path sorts the whole expansion stream globally, paying consecutive-query
binary searches (log2(N) random-gather passes) and the global N log^2 N
sort.

This module is the re-design around that cost:

  1. *plan* (on device): per-row product counts fr[i] = sum of B-row sizes
     over row i's entries (gathers + cumsum diffs — no scatter), category
     per row by pow2 thresholds, stable row permutation by category.  Only
     a tiny (n_cats, 2) stats table is fetched to size static shapes — the
     bucketing itself never leaves the device.
  2. *numeric per category* (one jit per category shape): expand ONLY that
     category's products into a compact stream (scatter+cummax repeat
     primitive, no binary search), lay the stream out as (rows, L) padded
     slabs with one gather, then sort each row independently along lanes —
     a batched lax.sort whose small per-row networks replace the global
     sort — merge duplicates with the shared segmented saturating scan,
     and re-sort to pack survivors first.
  3. *assemble* (one jit): per-row nnz -> row_ptr; one arithmetic gather
     pulls every CSR entry from the concatenated category slabs.

Categories bound padding waste to <= 2x (pow2 thresholds); skewed
power-law rows land in large-L categories with few rows, uniform torus
rows in one tight category — the load-balancing MAGNUS exists for.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..csr import SparseCSR
from ..semiring import Semiring
from . import segments
from .segments import INT32_SENTINEL

# pow2 category thresholds: max products per row a category accepts
THRESHOLDS = (64, 256, 1024, 4096, 16384, 65536)


def _pow2(x: int) -> int:
    return 1 << (max(int(x), 1) - 1).bit_length()


@jax.jit
def plan(a: SparseCSR, b: SparseCSR):
    """Device-side categorization: returns (fr, cat, perm, stats) where
    stats[c] = (row count, flop sum) per category (the only host fetch)."""
    valid = jnp.arange(a.capacity) < a.nnz
    col = jnp.clip(a.col_idx, 0, b.n_rows - 1)
    counts = jnp.where(valid, b.row_nnz()[col], 0).astype(jnp.int32)
    cin0 = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), segments.cumsum_blocked(counts)]
    )
    fr = cin0[a.row_ptr[1:]] - cin0[a.row_ptr[:-1]]  # (n,) products per row
    ths = jnp.asarray(THRESHOLDS, jnp.int32)
    cat = jnp.searchsorted(ths, fr, side="left").astype(jnp.int32)
    perm = jnp.argsort(cat, stable=True).astype(jnp.int32)
    n_cats = len(THRESHOLDS) + 1  # last = overflow
    onehot = cat[None, :] == jnp.arange(n_cats, dtype=jnp.int32)[:, None]
    rows_per = jnp.sum(onehot, axis=1).astype(jnp.int32)
    flops_per = jnp.sum(jnp.where(onehot, fr[None, :], 0), axis=1)
    return fr, cat, perm, jnp.stack([rows_per, flops_per], axis=1)


def shared_stream(a: SparseCSR, b: SparseCSR, cap_g: int):
    """Per-entry product machinery shared by EVERY category (and computed
    once per product): entry counts, inclusive cumsum, and the stream->
    entry map.  The first rowcat version recomputed these per category —
    two extra full-capacity scans each, which alone cost more than the
    global sort it was replacing."""
    cap_a = a.capacity
    valid_e = jnp.arange(cap_a) < a.nnz
    a_cols = jnp.clip(a.col_idx, 0, b.n_rows - 1)
    counts = jnp.where(valid_e, b.row_nnz()[a_cols], 0).astype(jnp.int32)
    cincl = segments.cumsum_blocked(counts)
    cin0 = jnp.concatenate([jnp.zeros((1,), jnp.int32), cincl])
    starts = jnp.where(counts > 0, cincl - counts, cap_g)
    src = segments.repeat_index(
        starts, jnp.arange(cap_a, dtype=jnp.int32), cap_g
    )
    # per-entry fused shift: b_pos = slot + shift[e] — one gather instead
    # of the cincl/counts/a_cols/row_ptr chains per padded slot
    shift = b.row_ptr[a_cols] - (cincl - counts)
    ok = cincl[-1] <= cap_g  # host sizes cap_g exactly; belt-and-braces
    return counts, cincl, cin0, src, shift, ok


def numeric_cat(a: SparseCSR, b: SparseCSR, rows: jnp.ndarray, fr: jnp.ndarray,
                L: int, shared):
    """One category: gather the selected rows' products straight into the
    (Rp, L) padded layout, batch-sort each row along lanes, merge
    duplicates (saturating), pack survivors first.

    rows: (Rp,) global row ids (n_rows = padding).  Returns
    (cols (Rp, L), totals limb tuple (Rp, L), nr (Rp,)).
    """
    sr = a.sr
    n = a.n_rows
    cap_a = a.capacity
    counts, cincl, cin0, src, shift, stream_ok = shared
    cap_g = src.shape[0]
    row_valid = rows < n
    rsafe = jnp.clip(rows, 0, n - 1)

    # direct padded expansion: per padded slot (r, l), find the covering
    # entry through the repeat stream's src map, then gather every product
    # operand ONCE, straight into the (Rp, L) layout — materializing an
    # intermediate product stream and re-gathering it costs 3+nlimbs extra
    # full random-gather passes
    off_r = cin0[a.row_ptr[rsafe]]
    fr_sel = jnp.where(row_valid, fr[rsafe], 0)
    l = jnp.arange(L, dtype=jnp.int32)
    ok_rl = l[None, :] < fr_sel[:, None]
    src_pad = jnp.clip(off_r[:, None] + l[None, :], 0, cap_g - 1)
    e = jnp.clip(src[src_pad], 0, cap_a - 1)
    b_pos = jnp.clip(src_pad + shift[e], 0, b.capacity - 1)
    cols_p = jnp.where(ok_rl, b.col_idx[b_pos], INT32_SENTINEL)
    v_p = sr.mul(sr.gather(a.values, e), sr.gather(b.values, b_pos))
    limbs_p = sr.where(ok_rl, v_p, sr.zeros(ok_rl.shape))

    # batched per-row sort by column (sentinels last)
    out = jax.lax.sort([cols_p, *limbs_p], dimension=-1, num_keys=1,
                       is_stable=False)
    cols_s, limbs_s = out[0], tuple(out[1:])

    # merge duplicate columns per row: lane-axis segmented saturating
    # scan (log2(L) combine passes; rows are independent by layout)
    prev = jnp.pad(cols_s[:, :-1], ((0, 0), (1, 0)), constant_values=-1)
    head = cols_s != prev
    totals, exact_ok = segments.segment_reduce_sorted(sr, head, limbs_s,
                                                      axis=1)
    stream_ok = stream_ok & exact_ok
    tail = jnp.concatenate(
        [head[:, 1:], jnp.ones((head.shape[0], 1), bool)], axis=1
    )
    keep = tail & (cols_s != INT32_SENTINEL) & ~sr.is_zero(totals)

    # pack survivors first (second batched sort on keyed columns)
    keyed = jnp.where(keep, cols_s, INT32_SENTINEL)
    tot2 = tuple(jnp.where(keep, x, 0) for x in totals)
    out2 = jax.lax.sort([keyed, *tot2], dimension=-1, num_keys=1,
                        is_stable=False)
    cols2, limbs2 = out2[0], tuple(out2[1:])
    nr = jnp.sum(keep, axis=1).astype(jnp.int32)
    # overflow guard: products dropped if the global stream overflowed
    nr = jnp.where(stream_ok, nr, -1)
    return cols2, limbs2, nr


@partial(jax.jit, static_argnames=("out_cap", "n_rows", "n_cols", "sr_name"))
def assemble(cols_concat, limbs_concat, base_of_row, nr_full,
             out_cap: int, n_rows: int, n_cols: int, sr_name: str):
    """Final CSR from concatenated category slabs: row_ptr from per-row
    counts, then ONE arithmetic gather per array (src = base_of_row[r] + k;
    slab rows hold survivors packed & column-sorted)."""
    from ..semiring import by_name

    sr = by_name(sr_name)
    row_ptr = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), segments.cumsum_blocked(nr_full)]
    ).astype(jnp.int32)
    nnz = row_ptr[-1]
    s = jnp.arange(out_cap, dtype=jnp.int32)
    r = segments.repeat_index(
        row_ptr[:-1], jnp.arange(n_rows, dtype=jnp.int32), out_cap
    )
    in_range = s < nnz
    rsafe = jnp.clip(r, 0, n_rows - 1)
    k = s - row_ptr[rsafe]
    buf_n = cols_concat.shape[0]
    src = jnp.clip(base_of_row[rsafe] + k, 0, buf_n - 1)
    col_idx = jnp.where(in_range, cols_concat[src], INT32_SENTINEL)
    vals = tuple(
        jnp.where(in_range, lb[src], 0) for lb in limbs_concat
    )
    nnz_out = jnp.where(
        (nnz <= out_cap) & jnp.all(nr_full >= 0), nnz, -1
    ).astype(jnp.int32)
    return SparseCSR(
        row_ptr=row_ptr, col_idx=col_idx, values=vals, nnz=nnz_out,
        n_rows=n_rows, n_cols=n_cols, sr_name=sr_name,
    )


@partial(jax.jit, static_argnames=("cap", "out_cap"))
def _esc_rows(a: SparseCSR, b: SparseCSR, row_mask: jnp.ndarray, cap: int,
              out_cap: int) -> SparseCSR:
    """Classic sort-based ESC restricted to the rows where ``row_mask`` is
    True — the per-category kernel for the overflow category (rows whose
    product count exceeds every padded-slab threshold)."""
    sr = a.sr
    cap_a = a.capacity
    a_rows = a.row_of_slot()
    valid_e = jnp.arange(cap_a) < a.nnz
    a_cols = jnp.clip(a.col_idx, 0, b.n_rows - 1)
    member = jnp.concatenate([row_mask, jnp.zeros((1,), bool)])
    counts = jnp.where(
        valid_e & member[jnp.clip(a_rows, 0, a.n_rows)],
        b.row_nnz()[a_cols], 0,
    ).astype(jnp.int32)
    cincl = segments.cumsum_blocked(counts)
    total = cincl[-1]
    t = jnp.arange(cap, dtype=jnp.int32)
    starts = jnp.where(counts > 0, cincl - counts, cap)
    src = segments.repeat_index(
        starts, jnp.arange(cap_a, dtype=jnp.int32), cap
    )
    ok = t < total
    src = jnp.clip(src, 0, cap_a - 1)
    shift = b.row_ptr[a_cols] - (cincl - counts)
    b_pos = jnp.clip(t + shift[src], 0, b.capacity - 1)
    i = jnp.where(ok, a_rows[src], a.n_rows)
    j = jnp.where(ok, b.col_idx[b_pos], INT32_SENTINEL)
    v = sr.mul(sr.gather(a.values, src), sr.gather(b.values, b_pos))
    v = sr.where(ok, v, sr.zeros((cap,)))
    c = SparseCSR.from_coo_device(i, j, v, a.n_rows, b.n_cols, sr, out_cap,
                                  valid=ok)
    nnz = jnp.where(total <= cap, c.nnz, -1).astype(jnp.int32)
    return dataclasses.replace(c, nnz=nnz)


def rowcat_config(a: SparseCSR, b: SparseCSR,
                  out_cap: Optional[int] = None):
    """Host half of the two-pass kernel: run plan(), fetch the (n_cats, 2)
    stats table, and derive the static shape configuration.  Returns
    (fr, cat, perm, cats, of_cap, out_cap) where cats is a static tuple of
    (L, rows_pad, rows_real, offset, cap_stream) per non-empty category."""
    fr, cat, perm, stats = plan(a, b)
    stats_h = np.asarray(jax.device_get(stats)).astype(np.int64)
    rows_per, flops_per = stats_h[:, 0], stats_h[:, 1]
    n_cats = len(THRESHOLDS) + 1
    of_cap = 0
    if rows_per[n_cats - 1] > 0:
        of_flops = int(flops_per[n_cats - 1])
        if of_flops >= 1 << 31:
            raise ValueError(
                f"overflow rows expand to {of_flops} products; "
                "use a dense-accumulator chain for this product"
            )
        of_cap = _pow2(of_flops)
    total_flops = int(flops_per[: n_cats - 1].sum())
    if int(flops_per.sum()) >= 1 << 31:
        raise ValueError(
            f"expansion of {int(flops_per.sum())} products too large")
    offsets = np.concatenate([[0], np.cumsum(rows_per)]).astype(np.int64)
    cats = tuple(
        (THRESHOLDS[c], max(_pow2(rows_per[c]), 8), int(rows_per[c]),
         int(offsets[c]))
        for c in range(n_cats - 1) if rows_per[c] > 0
    )
    # the shared product stream spans ALL rows (overflow included)
    cap_g = _pow2(max(int(flops_per.sum()), 1))
    cap = out_cap or _pow2(max(total_flops, 1))
    return fr, cat, perm, cats, of_cap, cap_g, cap


@partial(jax.jit, static_argnames=("cats", "of_cap", "cap_g", "out_cap"))
def rowcat_numeric(a: SparseCSR, b: SparseCSR, fr, cat, perm,
                   cats, of_cap: int, cap_g: int, out_cap: int) -> SparseCSR:
    """Device half: every per-category numeric pass, the overflow ESC
    fallback, and the final assembly fused into ONE program — the
    host-visible dispatch count dominates a multi-kernel pipeline at small
    shapes, so the whole numeric phase is a single dispatch."""
    sr = a.sr
    n = a.n_rows
    n_cats = len(THRESHOLDS) + 1

    overflow = None
    if of_cap > 0:
        overflow = _esc_rows(a, b, cat == n_cats - 1, of_cap, of_cap)
    if not cats:
        if overflow is not None:
            return overflow
        return SparseCSR.empty(n, b.n_cols, max(out_cap, 1), sr)

    max_rp = max(rp for (_, rp, _, _) in cats)
    perm_pad = jnp.concatenate(
        [perm, jnp.full((max_rp,), n, jnp.int32)]
    )
    shared = shared_stream(a, b, cap_g)

    slab_cols, slab_limbs, slab_nr, slab_rows, slab_L = [], [], [], [], []
    for L, rp_c, r_c, off in cats:
        rows_c = perm_pad[off: off + rp_c]
        # pow2 padding would otherwise leak the next category's rows into
        # this slice — mask the tail to the invalid row id
        rows_c = jnp.where(jnp.arange(rp_c) < r_c, rows_c, jnp.int32(n))
        cols2, limbs2, nr = numeric_cat(a, b, rows_c, fr, L, shared)
        slab_cols.append(cols2.reshape(-1))
        slab_limbs.append(tuple(x.reshape(-1) for x in limbs2))
        slab_nr.append(nr)
        slab_rows.append(rows_c)
        slab_L.append(L)

    cols_concat = jnp.concatenate(slab_cols)
    limbs_concat = tuple(
        jnp.concatenate([s[li] for s in slab_limbs])
        for li in range(sr.nlimbs)
    )
    # per-row slab base + per-row nnz (scatter n-sized, one pass)
    base_of_row = jnp.zeros((n,), jnp.int32)
    nr_full = jnp.zeros((n,), jnp.int32)
    base = 0
    for rows_c, nr, L in zip(slab_rows, slab_nr, slab_L):
        rp_c = rows_c.shape[0]
        bases = base + jnp.arange(rp_c, dtype=jnp.int32) * L
        idx = jnp.where(rows_c < n, rows_c, n)
        base_of_row = base_of_row.at[idx].set(bases, mode="drop")
        nr_full = nr_full.at[idx].set(nr, mode="drop")
        base += rp_c * L

    result = assemble(cols_concat, limbs_concat, base_of_row, nr_full,
                      out_cap, n, b.n_cols, sr.name)
    if overflow is not None:
        from .spgemm import spadd

        merged_cap = result.capacity + overflow.capacity
        poisoned = (result.nnz < 0) | (overflow.nnz < 0)
        merged = spadd(result.with_capacity(merged_cap),
                       overflow.with_capacity(merged_cap),
                       out_cap=merged_cap)
        # spadd sees a poisoned operand as empty; re-assert the poison
        result = dataclasses.replace(
            merged, nnz=jnp.where(poisoned, -1, merged.nnz).astype(jnp.int32)
        )
    return result


# above this global stream capacity the single fused program's compile time
# grows past minutes (on the machine this system was first written for);
# split into per-category programs instead — a few extra dispatches, each
# individually compilable
FUSE_MAX_CAP = 1 << 22

_shared_stream_jit = jax.jit(shared_stream, static_argnames=("cap_g",))
_numeric_cat_jit = jax.jit(numeric_cat, static_argnames=("L",))


def _rowcat_unfused(a: SparseCSR, b: SparseCSR, fr, cat, perm, cats,
                    of_cap: int, cap_g: int, out_cap: int) -> SparseCSR:
    """Per-category dispatches (compile-bounded path for large shapes)."""
    sr = a.sr
    n = a.n_rows
    n_cats = len(THRESHOLDS) + 1
    overflow = None
    if of_cap > 0:
        overflow = _esc_rows(a, b, cat == n_cats - 1, of_cap, of_cap)
    if not cats:
        return overflow if overflow is not None else SparseCSR.empty(
            n, b.n_cols, max(out_cap, 1), sr)

    max_rp = max(rp for (_, rp, _, _) in cats)
    perm_pad = jnp.concatenate([perm, jnp.full((max_rp,), n, jnp.int32)])
    shared = _shared_stream_jit(a, b, cap_g=cap_g)

    slab_cols, slab_limbs, slab_nr, slab_rows, slab_L = [], [], [], [], []
    for L, rp_c, r_c, off in cats:
        rows_c = jnp.where(jnp.arange(rp_c) < r_c,
                           perm_pad[off: off + rp_c], jnp.int32(n))
        cols2, limbs2, nr = _numeric_cat_jit(a, b, rows_c, fr, L, shared)
        slab_cols.append(cols2.reshape(-1))
        slab_limbs.append(tuple(x.reshape(-1) for x in limbs2))
        slab_nr.append(nr)
        slab_rows.append(rows_c)
        slab_L.append(L)

    cols_concat = jnp.concatenate(slab_cols)
    limbs_concat = tuple(
        jnp.concatenate([s[li] for s in slab_limbs])
        for li in range(sr.nlimbs)
    )
    base_of_row = jnp.zeros((n,), jnp.int32)
    nr_full = jnp.zeros((n,), jnp.int32)
    base = 0
    for rows_c, nr, L in zip(slab_rows, slab_nr, slab_L):
        rp_c = rows_c.shape[0]
        bases = base + jnp.arange(rp_c, dtype=jnp.int32) * L
        idx = jnp.where(rows_c < n, rows_c, n)
        base_of_row = base_of_row.at[idx].set(bases, mode="drop")
        nr_full = nr_full.at[idx].set(nr, mode="drop")
        base += rp_c * L

    result = assemble(cols_concat, limbs_concat, base_of_row, nr_full,
                      out_cap, n, b.n_cols, sr.name)
    if overflow is not None:
        from .spgemm import spadd

        merged_cap = result.capacity + overflow.capacity
        poisoned = (result.nnz < 0) | (overflow.nnz < 0)
        merged = spadd(result.with_capacity(merged_cap),
                       overflow.with_capacity(merged_cap),
                       out_cap=merged_cap)
        result = dataclasses.replace(
            merged, nnz=jnp.where(poisoned, -1, merged.nnz).astype(jnp.int32)
        )
    return result


def spgemm_rowcat(a: SparseCSR, b: SparseCSR,
                  out_cap: Optional[int] = None,
                  fused: Optional[bool] = None) -> SparseCSR:
    """C = A x B via on-device row categorization + per-category batched
    numeric kernels.  Host involvement: one (n_cats, 2) stats fetch to size
    the static shapes (the same two-pass role as spgemm_auto's flop
    fetch), then the numeric phase — ONE fused dispatch below
    FUSE_MAX_CAP (dispatch latency dominates small shapes), per-category
    dispatches above it (compile time dominates large shapes).  Rows whose
    product count exceeds the largest slab threshold take the sort-based
    ESC kernel (disjoint row support; merged with spadd)."""
    assert a.n_cols == b.n_rows, (a.shape, b.shape)
    fr, cat, perm, cats, of_cap, cap_g, cap = rowcat_config(a, b, out_cap)
    if fused is None:
        fused = cap_g <= FUSE_MAX_CAP
    if fused:
        return rowcat_numeric(a, b, fr, cat, perm, cats, of_cap, cap_g, cap)
    return _rowcat_unfused(a, b, fr, cat, perm, cats, of_cap, cap_g, cap)
