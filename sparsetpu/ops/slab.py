"""Slab ESC SpGEMM: chunked-B row-gather expansion + bin-packed batched
sort-merge + prefix-coalesce assembly.

The blocked ESC (ops/escb.py) is bounded by per-PRODUCT random gathers:
expansion resolves every padded slot through 4-5 full-stream gathers and
assembly adds an index scatter + output-sized gathers
(SPGEMM_APPROACHES.md §4c).  This module keeps the ESC algorithm but
restructures every per-product pass into per-ENTRY or per-CHUNK work:

  1. *chunk* B once per call: entries repacked device-side into
     chunk-aligned (ncc, C) column/value tables (pad cols = -1), so any
     B row is a run of C-wide chunks at a static stride.
  2. *expand* per SUB-ENTRY (one (A-entry, B-chunk) pair): one
     repeat_index over packed slots + three ROW gathers — jnp.take of
     (T, k) tables costs one index per row, far fewer than 1-D gathers,
     and it moves C+ elements per index.  The gathered chunk lands
     directly in its (nb, L) slab position: no per-product addressing
     exists anywhere.
  3. *sort + merge* per block: ONE batched lax.sort on TWO keys
     (row, col) — never the fused r*m+j key, whose int32 silently wraps
     past n*m > 2^31 (nell/ogbn scale; a latent hazard in escb this
     module retires) — then the native-plane segmented saturating merge
     (segments.segment_reduce_sorted).
  4. *pack + assemble*: a second batched sort brings survivors to block
     fronts in final order; compaction is then ARITHMETIC — block-of-
     position from one scatter+cummax, every payload through ONE packed
     row-gather — replacing escb's index scatter + K output gathers.
     row_ptr comes from one searchsorted over the (ascending) row stream.

Rows are bin-packed in NATURAL ORDER (next-fit; rows never straddle
blocks) so the coalesced stream is globally ordered by (row, col).  Rows
whose chunk count exceeds a block run in a second wide program and merge
via escb.merge_disjoint_rows; this is the MAGNUS role — locality-restoring
chunked accumulation with per-category programs (the reference's winning
large-scale kernel, src/graph_magnus.rs:225-242 / arXiv:2501.07056) —
with the accumulator data structure flipped to the batched sort/merge
form (SPGEMM_APPROACHES.md §3).
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

DEFAULT_L = 1 << 15   # lane width of a slab block (elements)
MAX_L = 1 << 20       # widest wide-row block
DEFAULT_C = 8         # B chunk width (columns gathered per sub-entry)


def _pow2(x: int) -> int:
    return 1 << (max(int(x), 1) - 1).bit_length()


@partial(jax.jit, static_argnames=("c",))
def plan_device(a: SparseCSR, b: SparseCSR, c: int):
    """Device half of planning: per-output-row chunk counts rc (in C-wide
    sub-entry units), B's total chunk count, and the max output value
    bound is left to callers.  One n-sized fetch serves the host pack —
    the same two-pass symbolic role as escb.row_flops."""
    deg_b = b.row_nnz().astype(jnp.int32)
    nch_b = -(-deg_b // c)
    valid = jnp.arange(a.capacity) < a.nnz
    acols = jnp.clip(a.col_idx, 0, b.n_rows - 1)
    cnt = jnp.where(valid, nch_b[acols], 0).astype(jnp.int32)
    cin0 = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(cnt, dtype=jnp.int32)]
    )
    rc = cin0[a.row_ptr[1:]] - cin0[a.row_ptr[:-1]]
    return rc, jnp.sum(nch_b), cin0[-1]


def pack_rows_ordered(rc: np.ndarray, lc: int):
    """Next-fit bin packing of rows (NATURAL order — the coalesced output
    must stay globally row-ordered) into blocks of lc sub-entry slots.
    Returns (sel_rows, starts_slot, nb); rows with rc == 0 are skipped and
    rows with rc > lc must be filtered by the caller."""
    sel = np.flatnonzero(rc > 0).astype(np.int32)
    starts = np.empty(len(sel), np.int32)
    block = 0
    used = 0
    for i, r in enumerate(sel):
        f = int(rc[r])
        if used + f > lc:
            block += 1
            used = 0
        starts[i] = block * lc + used
        used += f
    nb = block + 1 if len(sel) else 1
    return sel, starts, nb


@partial(jax.jit, static_argnames=("c", "ncc"))
def _chunk_tables(b: SparseCSR, c: int, ncc: int):
    """Repack B's entries into chunk-aligned tables: cols (ncc, c) int32
    with pad = -1, one (ncc, c) uint32/f32 table per value limb, and the
    per-row first-chunk index (n+1,).  One b-capacity-sized scatter."""
    deg = b.row_nnz().astype(jnp.int32)
    nch = -(-deg // c)
    chstart = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(nch, dtype=jnp.int32)]
    )
    valid = jnp.arange(b.capacity) < b.nnz
    rows = b.row_of_slot()
    rsafe = jnp.clip(rows, 0, b.n_rows - 1)
    off = jnp.arange(b.capacity, dtype=jnp.int32) - b.row_ptr[rsafe]
    pos = jnp.where(valid, chstart[rsafe] * c + off, ncc * c)
    cols = jnp.full((ncc * c,), -1, jnp.int32).at[pos].set(
        jnp.where(valid, b.col_idx, -1), mode="drop").reshape(ncc, c)
    vals = tuple(
        jnp.zeros((ncc * c,), l.dtype).at[pos].set(
            jnp.where(valid, l, jnp.zeros((), l.dtype)), mode="drop"
        ).reshape(ncc, c)
        for l in b.values
    )
    return cols, vals, chstart


@partial(jax.jit, static_argnames=("c", "l", "nb", "ncc", "sg", "out_cap",
                                   "narrow"))
def _numeric(a: SparseCSR, b: SparseCSR, sel_rows: jnp.ndarray,
             starts_slot: jnp.ndarray, rc: jnp.ndarray,
             c: int, l: int, nb: int, ncc: int, sg: int, out_cap: int,
             narrow: bool) -> SparseCSR:
    """One fused slab-ESC dispatch over the packed rows.  Rows not in
    ``sel_rows`` get zero output rows here (wide-row callers merge).

    ``narrow``: u64 with max(A)*max(B) < 2^32 (caller-verified) rides one
    u32 limb through expansion and sort; the merge reconstructs the hi
    limb exactly from plane carries."""
    sr = a.sr
    n, m = a.n_rows, b.n_cols
    cap_a = a.capacity
    lc = l // c
    nslot = nb * lc
    num_sel = sel_rows.shape[0]

    bcols, bvals, chstart_b = _chunk_tables(b, c, ncc)

    # ---- per-A-entry maps (E-sized)
    deg_b = b.row_nnz().astype(jnp.int32)
    nch_b = -(-deg_b // c)
    valid_e = jnp.arange(cap_a) < a.nnz
    acols = jnp.clip(a.col_idx, 0, b.n_rows - 1)
    cnt_e = jnp.where(valid_e, nch_b[acols], 0).astype(jnp.int32)
    cin_e = jnp.cumsum(cnt_e, dtype=jnp.int32)
    start_e = cin_e - cnt_e                      # natural sub-entry starts
    shift_e = chstart_b[acols] - start_e         # chunk_id = gnat + shift[e]
    # natural sub-entry stream -> entry id (scatter + cummax)
    starts_g = jnp.where(cnt_e > 0, start_e, sg)
    src_nat = segments.repeat_index(
        starts_g, jnp.arange(cap_a, dtype=jnp.int32), sg
    )
    # per-row natural starts, packed with sel tables for one row-gather
    srow = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), cin_e]
    )[a.row_ptr[:-1]]                            # (n,) natural start of row

    # ---- per-slot maps (nslot-sized)
    q = segments.repeat_index(
        starts_slot, jnp.arange(num_sel, dtype=jnp.int32), nslot
    )
    qs = jnp.clip(q, 0, num_sel - 1)
    # one (num_sel, 4) row-gather: row id, natural delta, start slot, rc
    sel_pack = jnp.stack(
        [sel_rows,
         srow[sel_rows] - starts_slot,
         starts_slot,
         rc[sel_rows]], axis=1)
    sp = jnp.take(sel_pack, qs, axis=0, mode="clip")
    r = sp[:, 0]
    slot = jnp.arange(nslot, dtype=jnp.int32)
    gnat = jnp.clip(sp[:, 1] + slot, 0, sg - 1)
    off = slot - sp[:, 2]
    ok_slot = (q >= 0) & (off < sp[:, 3])

    e = jnp.clip(src_nat[gnat], 0, cap_a - 1)

    def b32(x):  # lossless 32-bit pack (astype would clamp/convert)
        return jax.lax.bitcast_convert_type(x, jnp.int32)

    # entry-indexed pack: chunk shift + value limbs, one row-gather
    a_limbs = (a.values[0],) if narrow else a.values
    ent_pack = jnp.stack([shift_e] + [b32(x) for x in a_limbs], axis=1)
    ep = jnp.take(ent_pack, e, axis=0, mode="clip")
    chunk_id = jnp.clip(gnat + ep[:, 0], 0, ncc - 1)

    # ---- expansion: one row-gather of the fused (ncc, c*(1+limbs)) table
    nl = 1 if narrow else len(bvals)
    fused_b = jnp.concatenate(
        [bcols] + [b32(bvals[k]) for k in range(nl)], axis=1)
    g = jnp.take(fused_b, chunk_id, axis=0, mode="clip")
    bc = g[:, :c]
    # TWO sort keys (row, col), never a fused r*m+j: the fused int32 key
    # silently wraps once n*m > 2^31 (nell 65k / ogbn 169k squared) —
    # a latent hazard in escb's formulation this module retires
    ok = ok_slot[:, None] & (bc >= 0)
    krow = jnp.where(ok, jnp.broadcast_to(r[:, None], ok.shape),
                     INT32_SENTINEL)
    kcol = jnp.where(ok, bc, INT32_SENTINEL)

    def unb32(x, ref):
        return jax.lax.bitcast_convert_type(x, ref.dtype)

    if narrow:
        prod = unb32(ep[:, 1], a.values[0])[:, None] * \
            unb32(g[:, c:2 * c], b.values[0])
        v = (jnp.where(ok, prod, 0),)
    else:
        av = tuple(unb32(ep[:, 1 + k], a.values[k])[:, None]
                   for k in range(len(a.values)))
        bv = tuple(unb32(g[:, c * (1 + k):c * (2 + k)], b.values[k])
                   for k in range(len(bvals)))
        v = sr.mul(av, bv)
        v = tuple(jnp.where(ok, limb, jnp.zeros((), limb.dtype))
                  for limb in v)

    # ---- batched 2-key sort + lane merge
    krow2 = krow.reshape(nb, l)
    kcol2 = kcol.reshape(nb, l)
    limbs2 = tuple(x.reshape(nb, l) for x in v)
    out = jax.lax.sort([krow2, kcol2, *limbs2], dimension=1, num_keys=2,
                       is_stable=False)
    row_s, col_s, limbs_s = out[0], out[1], tuple(out[2:])
    prow = jnp.pad(row_s[:, :-1], ((0, 0), (1, 0)), constant_values=-1)
    pcol = jnp.pad(col_s[:, :-1], ((0, 0), (1, 0)), constant_values=-1)
    head = (row_s != prow) | (col_s != pcol)
    totals, exact_ok = segments.segment_reduce_sorted(sr, head, limbs_s,
                                                      axis=1)
    tail = jnp.concatenate([head[:, 1:], jnp.ones((nb, 1), bool)], axis=1)
    keep = tail & (row_s != INT32_SENTINEL) & ~sr.is_zero(totals)

    # ---- pack sort: survivors to block fronts in final (row, col) order
    pr = jnp.where(keep, row_s, INT32_SENTINEL)
    pc = jnp.where(keep, col_s, INT32_SENTINEL)
    pout = jax.lax.sort([pr, pc, *totals], dimension=1, num_keys=2,
                        is_stable=False)
    pr_s, pc_s, ptotals = pout[0], pout[1], tuple(pout[2:])

    sb = jnp.sum(keep, axis=1, dtype=jnp.int32)          # survivors/block
    offs = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(sb, dtype=jnp.int32)]
    )
    nnz = offs[-1]

    # ---- prefix-coalesce compaction, arithmetic-gather form: survivors
    # sit at block FRONTS after the pack sort, so output position t maps
    # to source (block, t - offs[block]) — block-of-t comes from one tiny
    # scatter + cummax (repeat_index), and ALL payload arrays ride ONE
    # packed row-gather instead of K 1-D gathers or the stream-sized index
    # scatter (segments.compact's cost).
    t = jnp.arange(out_cap, dtype=jnp.int32)
    bid = jnp.clip(
        segments.repeat_index(offs[:-1], jnp.arange(nb, dtype=jnp.int32),
                              out_cap),
        0, nb - 1)
    src = jnp.clip(bid * l + (t - offs[bid]), 0, nb * l - 1)
    if out_cap <= (1 << 21):
        # packed row-gather: ONE gather serves every payload — but a
        # device that tiles a 2-D s32 array to 128 lanes pads the k-wide
        # minor dim 32x.  Bounded to ~1 GB of padded temp (BOTH the
        # stacked source and the gather output pad; at ogbn scale the
        # pair was 33 GB); the bound awaits an H100 re-fit (ROADMAP C4)
        packed = jnp.stack(
            [pr_s.reshape(nb * l), pc_s.reshape(nb * l)]
            + [b32(x).reshape(nb * l) for x in ptotals], axis=1)
        g_out = jnp.take(packed, src, axis=0, mode="clip")
        cols_out = [g_out[:, j] for j in range(2 + len(ptotals))]
    else:
        # large out_cap: per-payload 1-D gathers keep every array
        # unpadded (k gathers beat one padded gather that cannot be
        # allocated)
        cols_out = [jnp.take(x.reshape(nb * l), src, mode="clip")
                    for x in (pr_s, pc_s)]
        cols_out += [jnp.take(b32(x).reshape(nb * l), src, mode="clip")
                     for x in ptotals]
    in_range = t < jnp.minimum(nnz, out_cap)
    orow = jnp.where(in_range, cols_out[0], jnp.int32(n))
    col_idx = jnp.where(in_range, cols_out[1], INT32_SENTINEL)
    vals = tuple(
        jnp.where(in_range, unb32(cols_out[2 + k], limb_ref),
                  jnp.zeros((), limb_ref.dtype))
        for k, limb_ref in enumerate(totals))
    row_ptr = jnp.searchsorted(
        orow, jnp.arange(n + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    nnz_out = jnp.where((nnz <= out_cap) & exact_ok, nnz, -1)
    return SparseCSR(
        row_ptr=row_ptr, col_idx=col_idx, values=vals,
        nnz=nnz_out.astype(jnp.int32),
        n_rows=n, n_cols=m, sr_name=sr.name,
    )


def spgemm_slab(a: SparseCSR, b: SparseCSR,
                out_cap: Optional[int] = None,
                L: int = DEFAULT_L, C: int = DEFAULT_C) -> SparseCSR:
    """C = A x B via slab ESC.  Host involvement: one n-sized rc fetch +
    the natural-order bin packing; then one fused numeric dispatch (two
    when wide rows force a second lane width)."""
    assert a.n_cols == b.n_rows, (a.shape, b.shape)
    assert a.sr_name == b.sr_name, (a.sr_name, b.sr_name)
    from .spgemm import narrow_u64_ok, symbolic_flops_exact
    from .escb import merge_disjoint_rows

    narrow = a.sr_name == "u64" and narrow_u64_ok(a, b)
    if int(jax.device_get(a.nnz)) < 0 or int(jax.device_get(b.nnz)) < 0:
        # poisoned input: propagate (the empty-plan path below would
        # otherwise launder a poisoned operand into a clean empty result)
        import dataclasses

        out = SparseCSR.empty(a.n_rows, b.n_cols, max(out_cap or 1, 1), a.sr)
        return dataclasses.replace(out, nnz=jnp.asarray(-1, jnp.int32))
    rc_dev, nch_total, sg_dev = plan_device(a, b, C)
    rc = np.asarray(jax.device_get(rc_dev)).astype(np.int64)
    ncc = max(int(jax.device_get(nch_total)), 1)
    sg = _pow2(max(int(jax.device_get(sg_dev)), 1))
    total_chunks = int(rc.sum())
    if total_chunks * C >= 1 << 31:
        raise ValueError(
            f"expansion of {total_chunks * C} slots cannot be materialized")
    if out_cap is None:
        out_cap = _pow2(max(min(symbolic_flops_exact(a, b),
                                a.n_rows * b.n_cols), 1))

    lc = L // C
    wide = rc > lc
    l2 = 0
    if wide.any():
        wmax = int(rc[wide].max()) * C
        if wmax > MAX_L:
            raise ValueError(
                f"row expands to {wmax} slots (> {MAX_L}); route to a "
                "dense-accumulator path")
        l2 = _pow2(wmax)

    def run(mask, lane):
        rc_m = np.where(mask, rc, 0)
        sel, starts, nb = pack_rows_ordered(rc_m, lane // C)
        if len(sel) == 0:
            return None
        return _numeric(
            a, b, jnp.asarray(sel), jnp.asarray(starts),
            jnp.asarray(rc.astype(np.int32)), C, lane, nb, ncc, sg,
            out_cap, narrow,
        )

    narrow_res = run(~wide, L)
    wide_res = run(wide, l2) if l2 else None
    if narrow_res is None and wide_res is None:
        return SparseCSR.empty(a.n_rows, b.n_cols, max(out_cap, 1), a.sr)
    if wide_res is None:
        return narrow_res
    if narrow_res is None:
        return wide_res
    return merge_disjoint_rows(narrow_res, wide_res, out_cap)
