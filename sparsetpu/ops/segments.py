"""Sorted-segment primitives: the vector backbone of every sparse kernel.

The reference's kernels accumulate into per-row dense/BTreeMap scratch
(src/graph_csr.rs:306-346); here everything stays flat sorted streams and
uses sort + segmented scans, which vectorize without any scalar scatter
loops.

Core primitives:
  - ``sort_by_keys``:      multi-operand lexicographic sort (lax.sort).
  - ``segment_reduce_sorted``: saturating segmented reduction over a sorted
    key stream via ``jax.lax.associative_scan`` (saturating unsigned add is
    associative, so the classic segmented-scan combine applies).
  - ``compact``:           stable front-compaction of masked entries.

All shapes are static; invalid/padded entries carry a sentinel key that sorts
last and is dropped during compaction.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import numpy as np
import jax.numpy as jnp

from ..semiring import Semiring, Value

# np (not jnp) scalar: a module-level jnp constant would initialize the XLA
# backend at import time, which breaks jax.distributed.initialize() in
# multi-host processes (dist/multihost.py) — np.int32 interoperates with
# every jnp op identically
INT32_SENTINEL = np.int32(0x7FFFFFFF)
_U32_MAX = np.uint32(0xFFFFFFFF)


# lane width for two-level scans: a 1-D associative_scan's XLA compile time
# grows superlinearly with array length because the log2(n) slice/update
# tree is laid out per level, and composing even the two-level form with
# the surrounding pad/reshape/flatten/slice stalled the compiler of the
# machine this system was first written for, while the native cumulative
# HLO ops (lax.cumsum / lax.cummax) compile quickly at any length.  All hot
# primitives therefore use native cumulative ops; blocked_scan remains
# only for the f32 segmented scan (order-sensitive float fold, no native
# reformulation) and is kept to ~4M elements.
BLOCKED_SCAN_L = 1 << 15


def blocked_scan(combine, elems, identity, L: int = BLOCKED_SCAN_L):
    """Inclusive 1-D associative scan via block-local scans + carry.

    ``elems``: pytree of same-length 1-D arrays; ``identity``: matching
    pytree of per-array identity scalars for ``combine`` (pads the tail
    block and seeds the carry).  ``combine`` must be associative and
    broadcast elementwise (it receives (nb, 1) carries against (nb, L)
    blocks).
    """
    leaves, treedef = jax.tree_util.tree_flatten(elems)
    ids = treedef.flatten_up_to(identity)
    n = leaves[0].shape[0]
    if n <= 2 * L:
        return jax.lax.associative_scan(combine, elems)
    nb = -(-n // L)
    pad = nb * L - n
    blocks = treedef.unflatten([
        jnp.concatenate([e, jnp.full((pad,), i, e.dtype)]).reshape(nb, L)
        for e, i in zip(leaves, ids)
    ])
    scanned = jax.lax.associative_scan(combine, blocks, axis=1)
    s_leaves = treedef.flatten_up_to(scanned)
    carry_incl = jax.lax.associative_scan(
        combine, treedef.unflatten([s[:, -1] for s in s_leaves])
    )
    carry = treedef.unflatten([
        jnp.concatenate([jnp.full((1,), i, c.dtype), c[:-1]])[:, None]
        for c, i in zip(treedef.flatten_up_to(carry_incl), ids)
    ])
    out = combine(carry, scanned)
    return treedef.unflatten([
        o.reshape(nb * L)[:n] for o in treedef.flatten_up_to(out)
    ])


def cumsum_blocked(x: jnp.ndarray) -> jnp.ndarray:
    """Inclusive 1-D cumsum via the native ``lax.cumsum`` HLO op.

    Native rather than an associative scan: see the BLOCKED_SCAN_L note.
    """
    return jax.lax.cumsum(x)


def cummax_1d(x: jnp.ndarray) -> jnp.ndarray:
    """Inclusive 1-D running max via the native ``lax.cummax`` HLO op
    (same compile-ceiling story as :func:`cumsum_blocked`)."""
    return jax.lax.cummax(x)


def repeat_index(starts: jnp.ndarray, values: jnp.ndarray, length: int,
                 fill=-1) -> jnp.ndarray:
    """out[t] = values[e] for the segment e covering position t, where
    segment e occupies [starts[e], starts[e+1]).

    The classic "repeat each value count times" primitive.  A
    ``searchsorted(cum, arange(length))`` formulation costs log2(length)
    *random-gather passes over the whole stream*, the hidden bottleneck of
    the ESC expansion.  This version is one small scatter (len(starts)) +
    one native cummax: out-of-range starts are dropped, positions before
    the first start carry ``fill``.
    """
    marks = jnp.full((length,), fill, values.dtype)
    marks = marks.at[starts].max(values, mode="drop")
    return jax.lax.cummax(marks)


def sort_by_keys(keys: Sequence[jnp.ndarray], payloads: Sequence[jnp.ndarray]):
    """Lexicographic stable sort by `keys`; returns (sorted_keys, sorted_payloads)."""
    operands = list(keys) + list(payloads)
    out = jax.lax.sort(operands, num_keys=len(keys), is_stable=True)
    return out[: len(keys)], out[len(keys):]


def _shift_right_one(x: jnp.ndarray, fill) -> jnp.ndarray:
    return jnp.concatenate([jnp.full((1,), fill, x.dtype), x[:-1]])


def segment_heads(keys: Sequence[jnp.ndarray]) -> jnp.ndarray:
    """Boolean array: True where a new key-segment starts (element 0 is True)."""
    head = None
    for k in keys:
        prev = _shift_right_one(k, k.dtype.type(-1) if jnp.issubdtype(k.dtype, jnp.signedinteger) else 0)
        differs = k != prev
        head = differs if head is None else (head | differs)
    head = head.at[0].set(True)
    return head


def _recombine_sat16(sr: Semiring, planes) -> Value:
    """16-bit plane sums (each uint32 < 2^32) -> saturated limb tuple.

    Plane k carries the segment sum of the inputs' bits [16k, 16k+16);
    ripple the inter-plane carries in 16-bit steps (each partial < 2^17,
    no wrap) and saturate on overflow past the semiring width — exactly
    the fold-of-saturating-adds result, since for non-negative values
    that fold equals min(true sum, MAX)."""
    m16 = jnp.uint32(0xFFFF)
    if sr.name == "u32":
        p0, p1 = planes
        t1 = (p0 >> 16) + (p1 & m16)
        over = ((p1 >> 16) + (t1 >> 16)) > 0
        lo = (t1 << 16) | (p0 & m16)
        return (jnp.where(over, _U32_MAX, lo),)
    if len(planes) == 2:
        # narrow u64: values rode one u32 limb; the carries past bit 32
        # ARE the hi limb (t2 < 2^17 — can never reach u64 saturation)
        p0, p1 = planes
        t1 = (p0 >> 16) + (p1 & m16)
        t2 = (p1 >> 16) + (t1 >> 16)
        lo = (t1 << 16) | (p0 & m16)
        return (lo, t2)
    p0, p1, p2, p3 = planes
    t1 = (p0 >> 16) + (p1 & m16)
    t2 = (p1 >> 16) + (p2 & m16) + (t1 >> 16)
    t3 = (p2 >> 16) + (p3 & m16) + (t2 >> 16)
    over = ((p3 >> 16) + (t3 >> 16)) > 0
    lo = (t1 << 16) | (p0 & m16)
    hi = (t3 << 16) | (t2 & m16)
    return (jnp.where(over, _U32_MAX, lo), jnp.where(over, _U32_MAX, hi))


def _segment_running_native(sr: Semiring, heads: jnp.ndarray, values: Value,
                            axis: int):
    """Segmented saturating running totals from NATIVE cumulative ops only.

    Native ops rather than an associative scan (see the BLOCKED_SCAN_L
    note).  Saturating
    unsigned fold == min(true sum, MAX), so exact true sums suffice:
    split each uint32 limb into 16-bit planes, take MODULAR uint32 plane
    cumsums (wrap cancels in the start-base subtraction while each
    segment's true plane sum < 2^32), subtract the plane cumsum at the
    segment start (propagated by one native cummax + one gather), and
    ripple-recombine with saturation.

    Exact while every segment's RUNNING count of NONZERO elements stays
    < 2^16 (a 16-bit plane of 2^16 max-valued elements wraps uint32; zero
    elements — e.g. a padded sentinel tail, which forms one giant segment —
    cannot wrap anything).  Returns (totals, exact_ok); the caller must
    poison its output when exact_ok is False — the framework's
    loud-failure discipline."""
    idx = jax.lax.broadcasted_iota(jnp.int32, heads.shape, axis)
    s = jax.lax.cummax(jnp.where(heads, idx, -1), axis=axis)
    s = jnp.clip(s, 0, None)

    def seg_running(p):
        c = jax.lax.cumsum(p, axis=axis)
        ce = c - p
        base = (ce[s] if axis == 0 and heads.ndim == 1
                else jnp.take_along_axis(ce, s, axis=axis))
        return c - base

    nonzero = values[0] != 0
    for limb in values[1:]:
        nonzero = nonzero | (limb != 0)
    run_nz = seg_running(nonzero.astype(jnp.uint32))
    exact_ok = jnp.all(run_nz < 0xFFFF)
    planes = []
    for limb in values:
        planes.append(limb & jnp.uint32(0xFFFF))
        planes.append(limb >> 16)
    return _recombine_sat16(sr, [seg_running(p) for p in planes]), exact_ok


def segment_reduce_sorted(sr: Semiring, heads: jnp.ndarray, values: Value,
                          axis: int = 0):
    """Segmented inclusive scan-totals: position i holds the running segment
    sum.  Returns ``(totals, exact_ok)``; the *segment total* lives at each
    segment's last element.

    Integer semirings ride the native-op plane formulation
    (:func:`_segment_running_native`) — compile-bounded at any size probed.
    f32 keeps the associative-scan fold (a float segmented sum has no
    order-preserving native reformulation; diff-of-cumsum would lose
    precision to the global running sum), combine op:
      (v1, h1) . (v2, h2) = (v2 if h2 else v1 (+) v2,  h1 | h2)
    which is associative; its compile ceiling (~4M elements 1-D) stands
    for f32 only."""
    if sr.name != "f32":
        return _segment_running_native(sr, heads, values, axis)

    def combine(a, b):
        va, ha = a[:-1], a[-1]
        vb, hb = b[:-1], b[-1]
        summed = sr.add(va, vb)
        v = tuple(jnp.where(hb, y, s) for y, s in zip(vb, summed))
        return (*v, ha | hb)

    init = (*values, heads)
    if axis == 0 and heads.ndim == 1:
        identity = (*(l.dtype.type(0) for l in values), False)
        out = blocked_scan(combine, init, identity)
    else:
        out = jax.lax.associative_scan(combine, init, axis=axis)
    return out[:-1], jnp.asarray(True)


def compact(keep: jnp.ndarray, arrays: Sequence[jnp.ndarray], fill_values, out_size: int):
    """Stable-compact elements where ``keep`` to the front of ``out_size`` arrays.

    Entries beyond capacity are silently dropped (mode='drop').  Returns
    (compacted_arrays, count) where count = total number of kept entries
    (may exceed out_size if capacity was too small — caller checks).

    One index scatter + K gathers, not K full-stream scatters: scattering
    every payload array directly would cost K scatter passes at the stream
    size; scattering only the source *indices* once and gathering the
    payloads through them does the same work with one.
    """
    n = keep.shape[0]
    pos = cumsum_blocked(keep.astype(jnp.int32)) - 1
    idx = jnp.where(keep, pos, out_size)  # out-of-bounds => dropped
    src = jnp.full((out_size,), n, jnp.int32)  # n => gather fill below
    src = src.at[idx].set(jnp.arange(n, dtype=jnp.int32), mode="drop")
    outs = []
    for a, fill in zip(arrays, fill_values):
        padded = jnp.concatenate(
            [a, jnp.full((1,) + a.shape[1:], fill, a.dtype)]
        )
        outs.append(padded[src])
    count = jnp.sum(keep.astype(jnp.int32))
    return outs, count


def reduce_sorted_coo(
    sr: Semiring,
    keys: Sequence[jnp.ndarray],
    values: Value,
    valid: jnp.ndarray,
    out_size: int,
    key_fills: Sequence,
    drop_zeros: bool = True,
):
    """Sort-free dedup of an already-sorted COO stream.

    Given sorted keys (invalid entries sorted last with sentinel keys),
    merges duplicate keys with saturating add, optionally drops zero totals
    (reference from_coo filters zeros, src/graph_csr.rs:106-118), and
    compacts to the front.  Returns (out_keys, out_values, nnz).

    Integer semirings take the pass-minimal route: segment totals are
    ADJACENT DIFFS of native plane cumsums evaluated at the compacted tail
    positions — dropped (all-zero) segments contribute nothing to any
    cumsum, so diffs across them stay exact.  Versus running the full
    segmented scan and compacting its totals, this trades the scan's
    full-stream base gathers for out_size-sized ones (out <= stream
    always); random-gather passes are the stream's budget currency
    (SPGEMM_APPROACHES.md §1).  f32 keeps the scan fold.
    """
    heads = segment_heads(keys)
    n = keys[0].shape[0]
    tail = jnp.concatenate([heads[1:], jnp.ones((1,), bool)])
    if sr.name == "f32":
        totals, exact_ok = segment_reduce_sorted(sr, heads, values)
        keep = tail & valid
        if drop_zeros:
            keep = keep & ~sr.is_zero(totals)
        arrays = list(keys) + list(totals)
        fills = list(key_fills) + [jnp.zeros((), sr.dtype)] * len(totals)
        outs, count = compact(keep, arrays, fills, out_size)
        nk = len(keys)
        count = jnp.where(exact_ok, count, -1)
        return outs[:nk], tuple(outs[nk:]), count

    nonzero = values[0] != 0
    for limb in values[1:]:
        nonzero = nonzero | (limb != 0)
    nonzero = nonzero & valid
    planes = [nonzero.astype(jnp.uint32)]
    for limb in values:
        v = jnp.where(valid, limb, 0)
        planes.append(v & jnp.uint32(0xFFFF))
        planes.append(v >> 16)
    cums = [jax.lax.cumsum(p) for p in planes]
    if drop_zeros:
        # a segment survives iff it has a nonzero element: running nonzero
        # count > 0 at its tail (cummax-propagated segment base)
        idx = jnp.arange(n, dtype=jnp.int32)
        s = jnp.clip(jax.lax.cummax(jnp.where(heads, idx, -1)), 0, None)
        run_nz = cums[0] - (cums[0] - planes[0])[s]
        keep = tail & valid & (run_nz > 0)
    else:
        keep = tail & valid
    arrays = list(keys) + cums
    fills = list(key_fills) + [jnp.uint32(0)] * len(cums)
    outs, count = compact(keep, arrays, fills, out_size)
    nk = len(keys)
    # adjacent diffs of the compacted inclusive cumsums = segment sums
    # (position 0 diffs against zero; compact's fill keeps the tail inert)
    def _diff(c):
        return c - jnp.concatenate([jnp.zeros((1,), c.dtype), c[:-1]])

    in_range = jnp.arange(out_size, dtype=jnp.int32) < count
    nz_seg = jnp.where(in_range, _diff(outs[nk]), 0)
    sums = [jnp.where(in_range, _diff(c), 0) for c in outs[nk + 1:]]
    totals = _recombine_sat16(sr, sums)
    # plane exactness: every segment's nonzero count under 2^16 (see
    # _segment_running_native); poison the count past it
    exact_ok = jnp.all(nz_seg < 0xFFFF)
    count = jnp.where(exact_ok, count, -1)
    return outs[:nk], totals, count
