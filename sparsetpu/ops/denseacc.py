"""Dense-accumulator general SpGEMM: C = A x B via B-densify + row SpMM.

The fourth SpGEMM kernel category (after ESC, blocked ESC, and rowcat): the
reference's per-row dense-scratch Gustavson loop (src/graph_csr.rs:306-346)
for the case where the scratch is the FULL output row.  Instead of
expanding and sorting partial products (cost ~ products x sort passes),
densify B once (one device scatter) and stream C rows through the chain's
row-streaming kernel (kernels/spmm_pallas.py):

    for each A entry (i, k, v):  C[i, :] += v * B_dense[k, :]

Cost: nnz(A) reads of a B row + one dense->CSR pack of the (n, m) product
— *independent of the product count*, so it wins over sort-based ESC
exactly where Gustavson wins on CPU: dense-ish products and hub rows whose
expansions explode (power-law).  It loses where m is huge and nnz tiny
(every entry reads a full output row).

Exactness: values ride f32; exact while max(C) < 2^24 — checked ON DEVICE,
poisoning nnz to -1 (the u64-saturating discipline, .check() raises).
Memory: B_dense + C_dense are (n, ~m) f32 — 2.9 GB each at n=27000.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..csr import SparseCSR
from ..semiring import U64
from ..kernels import spmm_pallas as sp


def _pow2(x: int) -> int:
    return 1 << (max(int(x), 1) - 1).bit_length()


def _dense_to_csr_lanesort(dense: jnp.ndarray, sr_name: str,
                           cap: int) -> "SparseCSR":
    """Dense carrier (n, m) -> SparseCSR via batched LANE SORT pack.

    Row-wise sort compaction (one batched sort per row) instead of
    from_dense_device's flat-nonzero scatter of the whole n*m stream.
    Stable lane order keeps columns ascending; capacity overflow poisons
    nnz to -1.

    ``dense`` may be the usual f32 carrier or an int32 carrier (the wide
    dense-dense route, values < 2^31 — f32 cannot hold them exactly)."""
    from ..ops import segments
    from ..ops.segments import INT32_SENTINEL

    n, m = dense.shape
    mask = dense != 0
    key = jnp.where(mask, jax.lax.broadcasted_iota(jnp.int32, (n, m), 1),
                    INT32_SENTINEL)
    key_s, val_s = jax.lax.sort([key, dense], dimension=1, num_keys=1,
                                is_stable=False)
    counts = jnp.sum(mask.astype(jnp.int32), axis=1)
    rp = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts, dtype=jnp.int32)])
    s = jnp.arange(cap, dtype=jnp.int32)
    r = segments.repeat_index(rp[:-1], jnp.arange(n, dtype=jnp.int32), cap)
    rs = jnp.clip(r, 0, n - 1)
    kk = jnp.clip(s - rp[rs], 0, m - 1)
    valid = (r >= 0) & (s < rp[-1])
    col = jnp.where(valid, key_s[rs, kk], INT32_SENTINEL)
    zero = jnp.zeros((), dense.dtype)
    val = jnp.where(valid, val_s[rs, kk], zero)
    nnz = jnp.where(rp[-1] <= cap, rp[-1], -1).astype(jnp.int32)
    if dense.dtype == jnp.int32:
        limbs = _limbs_from_i32(val, sr_name)
    else:
        limbs = _limbs_from_f32(val, sr_name)
    return SparseCSR(row_ptr=rp, col_idx=col,
                     values=limbs, nnz=nnz,
                     n_rows=n, n_cols=m, sr_name=sr_name)


def _limbs_from_i32(x: jnp.ndarray, sr_name: str):
    """Nonnegative int32 carrier -> limb tuple (values < 2^31)."""
    assert sr_name in ("u32", "u64"), sr_name
    lo = x.astype(jnp.uint32)
    if sr_name == "u32":
        return (lo,)
    return (lo, jnp.zeros_like(lo))


@partial(jax.jit, static_argnames=("cap",))
def dense_acc_numeric(op, b: SparseCSR, cap: int) -> SparseCSR:
    """Device half: densify B (column-padded), row SpMM, exactness check,
    CSR pack.  ``op`` is A's kernel operand (spmm_pallas.csr_operand)."""
    m = b.n_cols
    rows = b.row_of_slot()
    valid = jnp.arange(b.capacity) < b.nnz
    r = jnp.where(valid, rows, jnp.int32(b.n_rows))
    c_idx = jnp.where(valid, b.col_idx, 0)
    bf0 = _values_to_f32(b.values, b.sr_name)
    bdense = jnp.zeros((b.n_rows, sp.padded_width(m)), jnp.float32).at[
        r, c_idx].set(jnp.where(valid, bf0, 0.0), mode="drop")
    dense = sp.spmm_pallas(*op, bdense)[:, :m]
    if b.sr_name == "f32":
        exact = jnp.asarray(True)
    else:
        exact = jnp.max(dense) < float(1 << 24)
    out = _dense_to_csr_lanesort(dense, b.sr_name, cap)
    nnz = jnp.where(exact & (out.nnz >= 0), out.nnz, -1).astype(jnp.int32)
    import dataclasses

    return dataclasses.replace(out, nnz=nnz)


def _values_to_f32(values, sr_name: str) -> jnp.ndarray:
    """Limb tuple -> one f32 carrier array.  For u64 the hi limb rides as
    hi * 2^32 so any hi != 0 lands >= 2^24 and trips the exactness check."""
    bf = values[0].astype(jnp.float32)
    if sr_name == "u64":
        bf = bf + values[1].astype(jnp.float32) * float(1 << 32)
    return bf


def _limbs_from_f32(x: jnp.ndarray, sr_name: str):
    """f32 carrier -> limb tuple (exactness pre-checked by the caller)."""
    if sr_name == "f32":
        return (x,)
    lo = x.astype(jnp.uint32)
    if sr_name == "u32":
        return (lo,)
    return (lo, jnp.zeros_like(lo))


def _panel_dense(op, b: SparseCSR, lo, w: int):
    """Shared trace: densify B's columns [lo, lo+w) by device scatter (no
    full B_dense ever exists), run the row SpMM, return the dense C
    panel + exactness flag (integer semirings: all values < 2^24 so the f32
    carrier is exact; f32 semiring: always True, accumulation order is the
    panel's own)."""
    rows = b.row_of_slot()
    valid = (b.col_idx >= lo) & (b.col_idx < lo + w)
    r = jnp.where(valid, rows, jnp.int32(b.n_rows))
    c = jnp.where(valid, b.col_idx - lo, 0)
    bf = _values_to_f32(b.values, b.sr_name)
    panel = jnp.zeros((b.n_rows, w), jnp.float32).at[r, c].set(
        jnp.where(valid, bf, 0.0), mode="drop")
    dense = sp.spmm_pallas(*op, panel)
    if b.sr_name == "f32":
        exact = jnp.asarray(True)
    else:
        exact = jnp.max(dense) < float(1 << 24)
    return dense, exact


@partial(jax.jit, static_argnames=("w",))
def _panel_counts(op, b: SparseCSR, lo, w: int):
    """Sweep-1 program: per-row output nnz of one panel + exactness flag."""
    dense, exact = _panel_dense(op, b, lo, w)
    counts = jnp.sum((dense != 0).astype(jnp.int32), axis=1)
    return counts, exact


@partial(jax.jit, donate_argnums=(4, 5, 6), static_argnames=("w", "cap_p"))
def _panel_pack_merge(op, b: SparseCSR, lo, final_row_ptr, prior,
                      dst_col, dst_limbs, w: int, cap_p: int):
    """Sweep-2 program: recompute one dense panel, pack its nonzeros with a
    batched LANE SORT (instead of a flat-nonzero scatter over n*w
    elements), then scatter the cap_p-sized packed stream into the final
    arrays.

    Panels have disjoint increasing column ranges, so final (row, col)
    order is per-row offsets (final_row_ptr + prior) — NO global sort.
    All static shapes are panel-uniform so every program here compiles
    exactly once per product, not once per panel capacity."""
    from .segments import INT32_SENTINEL
    from . import segments

    n = op[0].shape[0] - 1
    dense, exact = _panel_dense(op, b, lo, w)
    mask = dense != 0
    # stable lane compaction: nonzeros keep ascending column order
    key = jnp.where(mask, jnp.arange(w, dtype=jnp.int32)[None, :],
                    INT32_SENTINEL)
    key_s, val_s = jax.lax.sort([key, dense], dimension=1, num_keys=1,
                                is_stable=False)
    counts = jnp.sum(mask.astype(jnp.int32), axis=1)
    rp = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts, dtype=jnp.int32)])
    # gather the packed entries out of the sorted panel
    s = jnp.arange(cap_p, dtype=jnp.int32)
    r = segments.repeat_index(rp[:-1], jnp.arange(n, dtype=jnp.int32), cap_p)
    rs = jnp.clip(r, 0, n - 1)
    kk = jnp.clip(s - rp[rs], 0, w - 1)
    valid = (r >= 0) & (s < rp[-1])
    col_l = key_s[rs, kk]
    val = val_s[rs, kk]
    # scatter into the final arrays at per-row offsets
    cap = dst_col.shape[0]
    dest = jnp.where(valid, final_row_ptr[rs] + prior[rs] + (s - rp[rs]),
                     jnp.int32(cap))
    dst_col = dst_col.at[dest].set(col_l + lo, mode="drop")
    limbs = _limbs_from_f32(val, b.sr_name)
    dst_limbs = tuple(d.at[dest].set(l, mode="drop")
                      for d, l in zip(dst_limbs, limbs))
    prior = prior + counts
    return dst_col, dst_limbs, prior, exact


def spgemm_dense_acc_tiled(a: SparseCSR, b: SparseCSR,
                           panel_cols: int = 8192) -> SparseCSR:
    """C = A x B through COLUMN-PANEL sweeps of the dense accumulator.

    The untiled path (spgemm_dense_acc) needs B_dense + C_dense = 2 (n, m)
    f32 arrays in HBM — dead at n >= ~28k.  This variant keeps only one
    (n, panel_cols) B panel + C panel live at a time, unlocking real-graph
    scale (nell 65k / ogbn_arxiv 169k, BASELINE configs 3-4) where every
    sort-based kernel exceeds the compile ceiling AND the dense product
    exceeds HBM.  Reference analog: the per-row dense-scratch Gustavson
    loop (src/graph_csr.rs:306-346) whose scratch is a column slice of the
    output row.

    Two sweeps over the panels (the reference's symbolic/numeric split,
    src/graph_csr.rs:350-484): sweep 1 runs the row SpMM per panel and
    keeps only per-row counts — these size ONE uniform static capacity and
    the exact final row_ptr; sweep 2 recomputes each panel and pack-merges
    it in place.  The extra numeric sweep re-reads nnz(A) B-panel rows;
    panel-uniform static shapes buy single-compile programs.

    Semirings: u64/u32 exact while every output value < 2^24 (checked on
    device per panel; violations poison nnz to -1).  f32 runs the plain
    float semiring; within-row accumulation order is A's entry order, so
    results may differ from sort-merge kernels by f32 rounding."""
    assert a.n_cols == b.n_rows, (a.shape, b.shape)
    assert a.sr_name == b.sr_name, (a.sr_name, b.sr_name)
    assert panel_cols % 1024 == 0, panel_cols
    n, m = a.n_rows, b.n_cols
    op = sp.csr_operand(a)
    n_panels = -(-m // panel_cols)

    # sweep 1: per-panel per-row counts (one program, one end sync)
    counts_dev = []
    exact_dev = []
    for pi in range(n_panels):
        cts, ex = _panel_counts(op, b, jnp.int32(pi * panel_cols),
                                panel_cols)
        counts_dev.append(cts)
        exact_dev.append(ex)
    counts_all = np.asarray(jax.device_get(jnp.stack(counts_dev)))
    all_exact = bool(jax.device_get(jnp.stack(exact_dev).all()))
    nnzp = counts_all.sum(axis=1)
    total = int(nnzp.sum())
    cap = _pow2(max(total, 1))
    cap_p = _pow2(max(int(nnzp.max(initial=1)), 1))
    row_totals = counts_all.sum(axis=0).astype(np.int64)
    final_row_ptr = jnp.asarray(
        np.concatenate([[0], np.cumsum(row_totals)]).astype(np.int32))

    # sweep 2: recompute + pack + merge, single compile across panels
    from .segments import INT32_SENTINEL

    dst_col = jnp.full((cap,), INT32_SENTINEL, jnp.int32)
    dst_limbs = a.sr.zeros((cap,))
    prior = jnp.zeros((n,), jnp.int32)
    for pi in range(n_panels):
        dst_col, dst_limbs, prior, _ = _panel_pack_merge(
            op, b, jnp.int32(pi * panel_cols), final_row_ptr, prior,
            dst_col, dst_limbs, panel_cols, cap_p)
    nnz = jnp.asarray(total if all_exact else -1, jnp.int32)
    return SparseCSR(row_ptr=final_row_ptr, col_idx=dst_col,
                     values=dst_limbs, nnz=nnz,
                     n_rows=n, n_cols=m, sr_name=a.sr_name)


def _densify(x: SparseCSR) -> jnp.ndarray:
    """Full (n_rows, n_cols) f32-carrier densification (one device scatter)."""
    rows = x.row_of_slot()
    valid = jnp.arange(x.capacity) < x.nnz
    r = jnp.where(valid, rows, jnp.int32(x.n_rows))
    c = jnp.where(valid, x.col_idx, 0)
    f = _values_to_f32(x.values, x.sr_name)
    return jnp.zeros((x.n_rows, x.n_cols), jnp.float32).at[r, c].set(
        jnp.where(valid, f, 0.0), mode="drop")


@partial(jax.jit, static_argnames=("cap",))
def densedense_numeric(a: SparseCSR, b: SparseCSR, cap: int) -> SparseCSR:
    """C = A x B as ONE dense matmul over densified operands + lane-sort pack.

    The fifth SpGEMM route: for small n a dense matmul is so much faster
    than any gather/sort pipeline that computing ALL n*k*m products —
    including the zeros — beats touching only the nonzero ones.  This is
    the reference's observation that dense BLAS wins above a few percent
    density, taken to its conclusion: the break-even moves to n <= a few
    thousand at ANY density.

    Exactness (integer semirings): `precision=HIGHEST` keeps full fp32
    products (no TF32), so with inputs < 2^16 (this tier's admission rule)
    and outputs < 2^24 every product and partial sum of non-negative
    integers is an integer below 2^24, exact in fp32.  All three bounds
    are checked ON DEVICE; violations poison nnz to -1.

    f32 pattern semantics: the lane-sort pack keeps only cells whose VALUE
    is nonzero, so f32 products whose signed terms cancel to exactly 0
    are dropped from the output pattern — the sort-path kernels (ESC)
    keep such merged zero-sum entries.  Values agree either way; only the
    explicit-zero pattern differs, and which one a mixed-sign f32 product
    gets now depends on spgemm_auto's cost-model route.  Callers that
    need ESC's pattern stability must force kernel="esc"/"escb".
    Integer semirings are unaffected (non-negative values cannot cancel)."""
    ad = _densify(a)
    bd = _densify(b)
    dense = jnp.dot(ad, bd, precision=jax.lax.Precision.HIGHEST)
    if a.sr_name == "f32":
        exact = jnp.asarray(True)
    else:
        exact = ((jnp.max(ad) < float(1 << 16)) &
                 (jnp.max(bd) < float(1 << 16)) &
                 (jnp.max(dense) < float(1 << 24)))
    out = _dense_to_csr_lanesort(dense, a.sr_name, cap)
    import dataclasses

    nnz = jnp.where(exact & (out.nnz >= 0), out.nnz, -1).astype(jnp.int32)
    return dataclasses.replace(out, nnz=nnz)


@partial(jax.jit, static_argnames=("cap",))
def densedense_numeric_i32(a: SparseCSR, b: SparseCSR, cap: int) -> SparseCSR:
    """Wide-window integer dense-dense: int32 matmul, exact for outputs
    < 2^30 — 64x the f32 route's 2^24 window (inputs may exceed 2^16 too).

    int32 dot_general wraps silently at 2^31, so overflow is detected by
    an f32 HIGHEST magnitude companion: with nonnegative integer inputs
    the f32 estimate tracks the true result within ~2^-20 relative, so
    `est < 2^30` certifies every int32 partial sum stayed below 2^31 (sums
    of nonnegative terms are monotone).  Input validity (every value
    < 2^31, u64 hi limbs zero) is checked from the limbs on device.
    An int32 matmul has no cuBLAS GEMM on a GPU; XLA emits its own kernel
    (time in PERF.md).  spgemm_auto uses it as the fallback tier between
    the f32 route and the sort kernels."""
    assert a.sr_name in ("u32", "u64"), a.sr_name

    def densify_i(x: SparseCSR):
        rows = x.row_of_slot()
        valid = jnp.arange(x.capacity) < x.nnz
        r = jnp.where(valid, rows, jnp.int32(x.n_rows))
        c = jnp.where(valid, x.col_idx, 0)
        lo = x.values[0]
        v = jnp.where(valid, lo, 0).astype(jnp.int32)
        d = jnp.zeros((x.n_rows, x.n_cols), jnp.int32).at[r, c].set(
            v, mode="drop")
        ok = jnp.max(jnp.where(valid, lo, 0)) < jnp.uint32(1 << 31)
        if x.sr_name == "u64":
            ok &= jnp.max(jnp.where(valid, x.values[1], 0)) == 0
        return d, ok

    ad, ok_a = densify_i(a)
    bd, ok_b = densify_i(b)
    est = jnp.dot(ad.astype(jnp.float32), bd.astype(jnp.float32),
                  precision=jax.lax.Precision.HIGHEST)
    dense = jax.lax.dot_general(ad, bd, (((1,), (0,)), ((), ())))
    exact = ok_a & ok_b & (jnp.max(est) < float(1 << 30))
    out = _dense_to_csr_lanesort(dense, a.sr_name, cap)
    import dataclasses

    nnz = jnp.where(exact & (out.nnz >= 0), out.nnz, -1).astype(jnp.int32)
    return dataclasses.replace(out, nnz=nnz)


def densedense_fits(n: int, k: int, m: int, budget_bytes: float = 6e9) -> bool:
    """Whether the dense-dense route's peak footprint (A, B, C + the pack
    sweep's two sorted copies of C — all f32) fits the HBM budget."""
    return 4.0 * (n * k + k * m + 3 * n * m) <= budget_bytes


def spgemm_dense_dense(a: SparseCSR, b: SparseCSR,
                       out_cap: Optional[int] = None,
                       wide: bool = False) -> SparseCSR:
    """C = A x B through the fully-dense route (see densedense_numeric).
    One device dispatch; u64/u32 exact below the checked value bounds.
    ``wide``: the int32 tier (densedense_numeric_i32), outputs < 2^30."""
    assert a.n_cols == b.n_rows, (a.shape, b.shape)
    assert a.sr_name == b.sr_name, (a.sr_name, b.sr_name)
    if out_cap is None:
        from .spgemm import symbolic_flops_exact

        out_cap = _pow2(min(symbolic_flops_exact(a, b),
                            a.n_rows * b.n_cols))
    if wide:
        return densedense_numeric_i32(a, b, out_cap)
    return densedense_numeric(a, b, out_cap)


def _mm_panel_dense(ad, b: SparseCSR, lo, w: int):
    """Densify B's columns [lo, lo+w) and matmul against the pre-densified
    A (HIGHEST) — the dense-matmul analog of _panel_dense.  Returns the dense C
    panel + per-panel exactness flag (A's input bound is checked once by
    the caller)."""
    rows = b.row_of_slot()
    valid = (b.col_idx >= lo) & (b.col_idx < lo + w)
    r = jnp.where(valid, rows, jnp.int32(b.n_rows))
    c = jnp.where(valid, b.col_idx - lo, 0)
    bf = _values_to_f32(b.values, b.sr_name)
    panel = jnp.zeros((b.n_rows, w), jnp.float32).at[r, c].set(
        jnp.where(valid, bf, 0.0), mode="drop")
    dense = jnp.dot(ad, panel, precision=jax.lax.Precision.HIGHEST)
    if b.sr_name == "f32":
        exact = jnp.asarray(True)
    else:
        exact = ((jnp.max(panel) < float(1 << 16)) &
                 (jnp.max(dense) < float(1 << 24)))
    return dense, exact


@partial(jax.jit, static_argnames=("w",))
def _mm_panel_counts(ad, b: SparseCSR, lo, w: int):
    dense, exact = _mm_panel_dense(ad, b, lo, w)
    counts = jnp.sum((dense != 0).astype(jnp.int32), axis=1)
    return counts, exact


@partial(jax.jit, donate_argnums=(4, 5, 6),
         static_argnames=("w", "cap_p"))
def _mm_panel_pack_merge(ad, b: SparseCSR, lo, final_row_ptr, prior,
                         dst_col, dst_limbs, w: int, cap_p: int):
    """Sweep-2 program of the tiled dense-dense route: recompute one C
    panel as a dense matmul, lane-sort pack, scatter at per-row offsets (same
    merge mechanics as _panel_pack_merge — panels have disjoint ascending
    column ranges, so no global sort)."""
    from . import segments
    from .segments import INT32_SENTINEL

    n = ad.shape[0]
    dense, exact = _mm_panel_dense(ad, b, lo, w)
    mask = dense != 0
    key = jnp.where(mask, jnp.arange(w, dtype=jnp.int32)[None, :],
                    INT32_SENTINEL)
    key_s, val_s = jax.lax.sort([key, dense], dimension=1, num_keys=1,
                                is_stable=False)
    counts = jnp.sum(mask.astype(jnp.int32), axis=1)
    rp = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts, dtype=jnp.int32)])
    s = jnp.arange(cap_p, dtype=jnp.int32)
    r = segments.repeat_index(rp[:-1], jnp.arange(n, dtype=jnp.int32), cap_p)
    rs = jnp.clip(r, 0, n - 1)
    kk = jnp.clip(s - rp[rs], 0, w - 1)
    valid = (r >= 0) & (s < rp[-1])
    col_l = key_s[rs, kk]
    val = val_s[rs, kk]
    cap = dst_col.shape[0]
    dest = jnp.where(valid, final_row_ptr[rs] + prior[rs] + (s - rp[rs]),
                     jnp.int32(cap))
    dst_col = dst_col.at[dest].set(col_l + lo, mode="drop")
    limbs = _limbs_from_f32(val, b.sr_name)
    dst_limbs = tuple(d.at[dest].set(l, mode="drop")
                      for d, l in zip(dst_limbs, limbs))
    prior = prior + counts
    return dst_col, dst_limbs, prior, exact


def densedense_tiled_panel_cols(n: int, k: int,
                                budget_bytes: float = 6e9) -> int:
    """Widest B/C column panel (multiple of 1024, capped at 8192) such
    that A_dense (n, k) + ~4 live (max(n,k), w) f32 panels fit the HBM
    budget.  0 when A_dense alone does not fit (n*k > ~1.2e9)."""
    rest = budget_bytes - 4.0 * n * k
    if rest <= 0:
        return 0
    w = int(rest // (16 * max(n, k, 1))) // 1024 * 1024
    return min(w, 8192)


def spgemm_dense_dense_tiled(a: SparseCSR, b: SparseCSR,
                             panel_cols: int = 8192) -> SparseCSR:
    """C = A x B: densify A ONCE, sweep B/C column panels as dense matmuls.

    Extends the fully-dense route (densedense_numeric) past the square
    HBM bound: peak footprint is A_dense (n, k) + a few (n|k, panel_cols)
    panels, so n up to ~30k fits where the untiled route dies at ~12k.
    Same two-sweep counts-first discipline as spgemm_dense_acc_tiled
    (exact final row_ptr from sweep 1; panel-uniform static shapes =
    one compile per program).  Exactness per the f32 tier: inputs < 2^16,
    every panel's outputs < 2^24, checked on device, poisoning nnz."""
    assert a.n_cols == b.n_rows, (a.shape, b.shape)
    assert a.sr_name == b.sr_name, (a.sr_name, b.sr_name)
    assert panel_cols % 1024 == 0, panel_cols
    n, m = a.n_rows, b.n_cols
    ad = _densify(a)
    if a.sr_name == "f32":
        a_ok = jnp.asarray(True)
    else:
        a_ok = jnp.max(ad) < float(1 << 16)
    n_panels = -(-m // panel_cols)

    counts_dev, exact_dev = [], [a_ok]
    for pi in range(n_panels):
        cts, ex = _mm_panel_counts(ad, b, jnp.int32(pi * panel_cols),
                                   panel_cols)
        counts_dev.append(cts)
        exact_dev.append(ex)
    counts_all = np.asarray(jax.device_get(jnp.stack(counts_dev)))
    all_exact = bool(jax.device_get(jnp.stack(exact_dev).all()))
    nnzp = counts_all.sum(axis=1)
    total = int(nnzp.sum())
    cap = _pow2(max(total, 1))
    cap_p = _pow2(max(int(nnzp.max(initial=1)), 1))
    row_totals = counts_all.sum(axis=0).astype(np.int64)
    final_row_ptr = jnp.asarray(
        np.concatenate([[0], np.cumsum(row_totals)]).astype(np.int32))

    from .segments import INT32_SENTINEL

    dst_col = jnp.full((cap,), INT32_SENTINEL, jnp.int32)
    dst_limbs = a.sr.zeros((cap,))
    prior = jnp.zeros((n,), jnp.int32)
    for pi in range(n_panels):
        dst_col, dst_limbs, prior, _ = _mm_panel_pack_merge(
            ad, b, jnp.int32(pi * panel_cols), final_row_ptr, prior,
            dst_col, dst_limbs, panel_cols, cap_p)
    nnz = jnp.asarray(total if all_exact else -1, jnp.int32)
    return SparseCSR(row_ptr=final_row_ptr, col_idx=dst_col,
                     values=dst_limbs, nnz=nnz,
                     n_rows=n, n_cols=m, sr_name=a.sr_name)


def spgemm_dense_acc(a: SparseCSR, b: SparseCSR,
                     out_cap: Optional[int] = None) -> SparseCSR:
    """C = A x B through the dense accumulator (u64/u32 exact below 2^24,
    f32 plain float).  One host prep of A + one fused device dispatch."""
    assert a.n_cols == b.n_rows, (a.shape, b.shape)
    assert a.sr_name == b.sr_name, (a.sr_name, b.sr_name)
    op = sp.csr_operand(a)
    if out_cap is None:
        # size the static output from a device nnz count of the dense
        # product's support; cheaper: upper-bound by min(n*m, flops) is
        # huge — run numeric once with the worst-case-free bound from a
        # symbolic count
        from .spgemm import symbolic_flops_exact

        out_cap = _pow2(min(symbolic_flops_exact(a, b),
                            a.n_rows * b.n_cols))
    return dense_acc_numeric(op, b, out_cap)
