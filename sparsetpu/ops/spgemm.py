"""SpGEMM and SpAdd over saturating semirings, fully vectorized.

The reference computes C = A x B with Gustavson row-wise scatter/gather into
dense scratch (src/graph_csr.rs:306-346) and a rayon two-pass variant
(:350-484).  Scalar scatter loops do not map to vector hardware, so this
module uses the ESC (expand–sort–compress) formulation instead:

  1. *symbolic*: flops(A,B) = sum over nnz (i,k) in A of row_nnz_B[k] — a
     gather + reduction, also the exact expansion size and an nnz(C) bound.
  2. *expand*: materialize all partial products (i, j, a_ik (x) b_kj) as flat
     streams via vectorized binary search (no data-dependent control flow).
  3. *compress*: sort by (i, j) and merge duplicates with a segmented
     saturating scan (ops/segments.py), yielding CSR directly.

Every step is jnp/lax ops under one jit; shapes are static via capacity
parameters.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..csr import SparseCSR
from ..semiring import by_name
from . import segments
from .segments import INT32_SENTINEL


def _pow2(x: int) -> int:
    return 1 << (max(int(x), 1) - 1).bit_length()


def symbolic_flops(a: SparseCSR, b: SparseCSR) -> jnp.ndarray:
    """Number of partial products in A x B (upper bound on nnz(C)).

    Mirrors the reference symbolic pass role (src/graph_csr.rs:363-403) but
    as a single gather+sum.  Device int32 scalar: exact below 2^31 products
    (any larger expansion cannot be materialized anyway); use
    :func:`symbolic_flops_exact` when the true count may exceed int32.
    """
    valid = jnp.arange(a.capacity) < a.nnz
    col = jnp.clip(a.col_idx, 0, b.n_rows - 1)
    counts = jnp.where(valid, b.row_nnz()[col], 0)
    return jnp.sum(counts)


@jax.jit
def _symbolic_flops_parts(a: SparseCSR, b: SparseCSR) -> jnp.ndarray:
    """Chunked partial sums of the per-entry product counts; each partial
    stays < 2^31 (chunk of 32 counts, each < n_rows(B) <= 2^26), so the
    host can combine them exactly in int64."""
    valid = jnp.arange(a.capacity) < a.nnz
    col = jnp.clip(a.col_idx, 0, b.n_rows - 1)
    counts = jnp.where(valid, b.row_nnz()[col], 0).astype(jnp.int32)
    pad = (-counts.shape[0]) % 32
    counts = jnp.pad(counts, (0, pad))
    return jnp.sum(counts.reshape(-1, 32), axis=1)


def symbolic_flops_exact(a: SparseCSR, b: SparseCSR) -> int:
    """Exact host-side flop count — immune to the int32 wrap a single
    device-side sum suffers at >= 2^31 products (where a wrapped value
    would silently under-size the expansion capacity)."""
    parts = np.asarray(jax.device_get(_symbolic_flops_parts(a, b)))
    return int(parts.astype(np.int64).sum())


@jax.jit
def _max_limbs(a: SparseCSR):
    valid = jnp.arange(a.capacity) < a.nnz
    return tuple(jnp.max(jnp.where(valid, l, 0)) for l in a.values)


def max_value(a: SparseCSR) -> int:
    """Host-side max stored value (one tiny sync); 0 for empty/f32-skip."""
    if a.sr_name == "f32":
        return 0
    limbs = [int(x) for x in jax.device_get(_max_limbs(a))]
    out = 0
    for k, l in enumerate(limbs):
        out |= l << (32 * k)
    return out


def narrow_u64_ok(a: SparseCSR, b: SparseCSR) -> bool:
    """True when every partial product provably fits u32 — the single-limb
    ESC fast path (two fewer full-stream gathers, one fewer sort payload,
    half the merge planes).  The chain/sweep workloads all qualify: path
    counts stay far below 2^16."""
    if a.sr_name != "u64" or b.sr_name != "u64":
        return False
    ma, mb = max_value(a), max_value(b)
    return ma < (1 << 32) and mb < (1 << 32) and ma * mb < (1 << 32)


def expand_products(a: SparseCSR, b: SparseCSR, expand_cap: int,
                    narrow: bool = False):
    """Materialize partial-product streams (i, j, v, valid) of size expand_cap.

    The entry covering each expansion slot comes from the scatter+cummax
    repeat primitive (segments.repeat_index) rather than a binary search:
    searchsorted with expand_cap consecutive queries costs log2 random-
    gather passes over the whole stream.

    ``narrow`` (u64 only; caller must have verified max(A) * max(B) < 2^32
    and hi limbs all zero): carry the product stream as ONE u32 limb —
    drops two full-stream hi-limb gathers here and one sort payload + two
    merge planes downstream; reduce_sorted_coo reconstructs the u64 hi
    limb from the plane carries."""
    assert a.n_cols == b.n_rows, (a.shape, b.shape)
    sr = a.sr
    valid_a = jnp.arange(a.capacity) < a.nnz
    a_rows = a.row_of_slot()
    a_cols = jnp.clip(a.col_idx, 0, b.n_rows - 1)
    counts = jnp.where(valid_a, b.row_nnz()[a_cols], 0).astype(jnp.int32)
    cum = segments.cumsum_blocked(counts)
    total = cum[a.capacity - 1] if a.capacity > 0 else jnp.int32(0)

    t = jnp.arange(expand_cap, dtype=jnp.int32)
    starts = jnp.where(counts > 0, cum - counts, expand_cap)  # drop empty
    src = segments.repeat_index(
        starts, jnp.arange(a.capacity, dtype=jnp.int32), expand_cap
    )
    valid_e = t < total
    src = jnp.clip(src, 0, a.capacity - 1)
    # per-entry fused shift: b_pos = t + (b_row_start - stream_start) —
    # one gather instead of four (cum/counts/a_cols/row_ptr chains); every
    # random-gather pass over the stream counts
    shift = b.row_ptr[a_cols] - (cum - counts)
    b_pos = jnp.clip(t + shift[src], 0, b.capacity - 1)

    # output row per slot: a second scatter+cummax over the same entry
    # starts (a_rows is monotone over entries, so the cummax propagates the
    # covering row) — one native scan instead of a full random gather
    i = segments.repeat_index(starts, jnp.clip(a_rows, 0, a.n_rows),
                              expand_cap)
    i = jnp.where(valid_e & (i >= 0), i, a.n_rows)
    j = jnp.where(valid_e, b.col_idx[b_pos], INT32_SENTINEL)
    if narrow:
        assert sr.name == "u64", sr.name
        prod = a.values[0][src] * b.values[0][b_pos]  # < 2^32, exact
        v = (jnp.where(valid_e, prod, 0),)
    else:
        v = sr.mul(sr.gather(a.values, src), sr.gather(b.values, b_pos))
        v = sr.where(valid_e, v, sr.zeros((expand_cap,)))
    return i, j, v, valid_e, total


@partial(jax.jit, static_argnames=("expand_cap", "out_cap", "narrow"))
def spgemm(a: SparseCSR, b: SparseCSR, expand_cap: int,
           out_cap: Optional[int] = None,
           narrow: bool = False) -> SparseCSR:
    """C = A x B on the matrix semiring. ``expand_cap`` must be >= flops(A,B)
    (see :func:`symbolic_flops`); ``out_cap`` defaults to ``expand_cap``.
    ``narrow``: see :func:`expand_products` (u64 with provably-small
    values rides one limb; outputs are full u64)."""
    out_cap = out_cap or expand_cap
    i, j, v, valid_e, total = expand_products(a, b, expand_cap,
                                              narrow=narrow)
    c = SparseCSR.from_coo_device(
        i, j, v, a.n_rows, b.n_cols, a.sr, out_cap, valid=valid_e
    )
    # expansion overflow (flops > expand_cap) silently drops products:
    # poison nnz so the host guard (SparseCSR.check) trips
    nnz = jnp.where(total <= expand_cap, c.nnz, -1).astype(jnp.int32)
    return dataclasses.replace(c, nnz=nnz)


@partial(jax.jit, static_argnames=("out_cap",))
def spadd(a: SparseCSR, b: SparseCSR, out_cap: Optional[int] = None) -> SparseCSR:
    """C = A (+) B elementwise with saturating add (reference CsrMatrix::add)."""
    assert a.shape == b.shape
    out_cap = out_cap or (a.capacity + b.capacity)
    sr = a.sr
    valid = jnp.concatenate(
        [jnp.arange(a.capacity) < a.nnz, jnp.arange(b.capacity) < b.nnz]
    )
    rows = jnp.concatenate([a.row_of_slot(), b.row_of_slot()])
    cols = jnp.concatenate([a.col_idx, b.col_idx])
    vals = tuple(jnp.concatenate([x, y]) for x, y in zip(a.values, b.values))
    return SparseCSR.from_coo_device(
        rows, cols, vals, a.n_rows, a.n_cols, sr, out_cap, valid=valid
    )


def dense_acc_panel_cols(n_rows: int, budget_bytes: float = 6e9) -> int:
    """Widest column panel (multiple of 1024, capped at 8192) such that the
    tiled dense accumulator's PEAK panel footprint fits the HBM budget:
    ~4 live (n_rows, w) f32 arrays at once (B panel / C panel / the pack
    sweep's lane-sorted key+value copies; a 2-array estimate ran out of
    memory on nell A^3).  Returns 0 when even a 1024-wide panel does not
    fit (n > ~360k).  The 6 GB budget is a device-memory bound that awaits
    a re-fit from H100 ledger lines (ROADMAP C4)."""
    w = int(budget_bytes // (16 * max(n_rows, 1))) // 1024 * 1024
    return min(w, 8192)


def spgemm_auto(a: SparseCSR, b: SparseCSR, round_to_pow2: bool = True,
                kernel: str = "auto") -> SparseCSR:
    """Host-driven SpGEMM: runs the symbolic pass, fetches the exact flop
    count, and self-routes to the best numeric kernel (the MagnusConfig
    role, src/graph_magnus.rs:225-242), by a cost model over the flop
    count and the shapes:

      - when BOTH operands densified fit device memory and the model says
        one dense matmul + pack undercuts the ESC expand/sort, the
        dense-dense route (ops/denseacc.py::spgemm_dense_dense) — a dense
        matmul computes all n*k*m products faster than a gather pipeline
        touches just the nonzero ones at small n.  Value-range violations
        (inputs >= 2^16 or outputs >= 2^24) poison on device and fall back
        to the sort paths;
      - small expansions: the single-dispatch sort-based ESC kernel;
      - larger expansions: column-chunked ESC (ops/colchunk.py) or the
        dense-accumulator paths (ops/denseacc.py), whose cost is
        independent of the product count;
      - otherwise the row-categorized kernel (ops/rowcat.py) — bounded
        per-category programs.

    The model's constants were fitted on the machine this system was first
    written for; they still pick a working route on an H100 and await a
    re-fit from H100 ledger lines (ROADMAP C4, B4).

    ``kernel`` forces a path: "esc" | "rowcat" | "denseacc" | "densedense"
    | "colchunk" | "slab" | "escb" | "auto"."""
    flops = symbolic_flops_exact(a, b)
    if kernel == "auto":
        from .denseacc import densedense_fits

        n, k, m = a.n_rows, a.n_cols, b.n_cols
        if densedense_fits(n, k, m):
            # cost model (constants await an H100 re-fit, ROADMAP C4):
            # per-element cost of the densify/sort/pack full-array passes,
            # effective dense-matmul rate at HIGHEST, per packed output
            # entry, and per partial product of the ESC expand/sort plus a
            # fixed dispatch
            t_dd = (1e-3 + 0.2e-9 * (n * k + k * m + 3 * n * m)
                    + 2.0 * n * k * m / 4.5e13
                    + 16e-9 * min(flops, n * m))
            t_esc = 2e-3 + flops * 110e-9
            if t_dd < t_esc:
                from .denseacc import spgemm_dense_dense

                # tier pre-selection from host-side value maxima (two tiny
                # syncs) instead of dispatching a tier that provably
                # poisons: the f32 tier needs both inputs < 2^16; the
                # int32 tier tolerates wider inputs but outputs < 2^30
                # (output bounds still checked on device)
                cap_dd = _pow2(min(flops, n * m))
                amax, bmax = max_value(a), max_value(b)
                f32_in_ok = (a.sr_name == "f32"
                             or (amax < (1 << 16) and bmax < (1 << 16)))
                tiers = ([False] if f32_in_ok else [])
                if a.sr_name in ("u32", "u64"):
                    tiers.append(True)  # int32 tier: outputs < 2^30
                for wide in tiers:
                    try:
                        return spgemm_dense_dense(
                            a, b, out_cap=cap_dd, wide=wide).check()
                    except ValueError:
                        pass  # on-device range check poisoned — next tier
                    except jax.errors.JaxRuntimeError as e:
                        # near the HBM boundary the wide tier's extra
                        # int32 product + f32 companion can exhaust
                        # memory even when densedense_fits passed (it
                        # models the f32 tier) — degrade to sort paths
                        if "RESOURCE_EXHAUSTED" not in str(e):
                            raise
        if flops <= (1 << 19):
            # small products: the monolithic ESC's single dispatch beats
            # the slab's plan+pack overhead
            kernel = "esc"
        else:
            # mid/large products: route by per-route cost constants
            # (awaiting an H100 re-fit, ROADMAP C4):
            #   colchunk (slab when one chunk): a cost per product, any n
            #     via column chunking;
            #   denseacc: a flat cost per n x m frame element, independent
            #     of the product count;
            #   denseacc_tiled: the same per element, for n where two
            #     dense frames do not fit; the only route past per-chunk
            #     budgets
            padded_cols = -(-b.n_cols // 1024) * 1024
            fits = a.n_rows * padded_cols * 4 * 2 <= 6e9
            w = dense_acc_panel_cols(a.n_rows)
            # colchunk memory: the per-row interleave holds every chunk's
            # packed output PLUS the final arrays (~3x output bytes); cap
            # the route at 2^28 products so the merge provably fits device
            # memory (nell A^4 at 531M products ran out without this)
            t_cc = (5e-3 + flops * 90e-9 if flops <= (1 << 28)
                    else float("inf"))
            t_dacc = (a.n_rows * padded_cols * 9e-9 if fits
                      else float("inf"))
            t_tiled = (a.n_rows * padded_cols * 4.3e-9
                       if (w and not fits) else float("inf"))
            kernel = "colchunk"
            if min(t_dacc, t_tiled) < t_cc:
                kernel = "denseacc" if t_dacc <= t_tiled else \
                    "denseacc_tiled"
            elif t_cc == float("inf"):
                # nothing fits: the row-categorized kernel's bounded
                # per-category programs are the last resort
                kernel = "rowcat"
    if flops >= 1 << 31 and kernel in ("esc", "rowcat"):
        # only the sort paths materialize the expansion; dense-accumulator
        # cost is independent of the product count (its own capacity guard
        # is the true output nnz, sized from measured per-panel counts)
        raise ValueError(
            f"spgemm expansion of {flops} products cannot be materialized "
            "(int32 indexing / HBM); split the product or use a dense path"
        )
    if kernel == "densedense":
        from .denseacc import spgemm_dense_dense

        return spgemm_dense_dense(a, b).check()
    if kernel in ("denseacc", "denseacc_tiled"):
        from .denseacc import spgemm_dense_acc, spgemm_dense_acc_tiled

        try:
            if kernel == "denseacc_tiled":
                w = dense_acc_panel_cols(a.n_rows)
                return spgemm_dense_acc_tiled(a, b, panel_cols=w).check()
            return spgemm_dense_acc(a, b).check()
        except ValueError:
            # value range too wide for the f32 path — sort fallback
            from .rowcat import spgemm_rowcat

            return spgemm_rowcat(a, b).check()
    if kernel == "colchunk":
        from .colchunk import spgemm_colchunk

        try:
            return spgemm_colchunk(a, b).check()
        except ValueError:
            # a hub row expands past the wide program in some chunk (or a
            # chunk poisoned) — fall back to the panel sweep when it fits,
            # else the row-categorized kernel
            if dense_acc_panel_cols(a.n_rows):
                from .denseacc import spgemm_dense_acc_tiled

                w = dense_acc_panel_cols(a.n_rows)
                return spgemm_dense_acc_tiled(a, b, panel_cols=w).check()
            kernel = "rowcat"
    if kernel == "rowcat":
        from .rowcat import spgemm_rowcat

        return spgemm_rowcat(a, b).check()
    if kernel in ("slab", "escb"):
        from .escb import spgemm_blocked
        from .slab import spgemm_slab

        fn = spgemm_slab if kernel == "slab" else spgemm_blocked
        return fn(a, b, out_cap=_pow2(min(flops, a.n_rows * b.n_cols))
                  ).check()
    cap = max(flops, 1)
    if round_to_pow2:
        cap = 1 << (cap - 1).bit_length()
    return spgemm(a, b, expand_cap=cap, narrow=narrow_u64_ok(a, b)).check()
