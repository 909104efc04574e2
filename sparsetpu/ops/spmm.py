"""Sparse x dense SpMM over a SparseCSR operand (the einsum planner's
lowering target) and dense -> CSR extraction.

The chain's dense-accumulator step C = A x P, where P is the whole dense
product, is the row-streaming kernel in kernels/spmm_pallas.py.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..csr import SparseCSR


@jax.jit
def spmm_csr_dense(a: SparseCSR, d: jnp.ndarray) -> jnp.ndarray:
    """C = A x D with A a 1-limb (f32) SparseCSR and D dense f32 of shape
    (a.n_cols, m) or (a.n_cols,).  One gather of D rows by A's column
    indices, scaled, segment-summed by row — never leaves the device.

    This is the SpMM lowering target for the einsum planner's sparse x dense
    matmul patterns (the reference VM walks the sparse operand's rows and
    reads the dense operand directly, linalg/src/einsum.rs:591-626).
    Exact for integer counts < 2^24 carried in f32.
    """
    valid = jnp.arange(a.capacity) < a.nnz
    rows = jnp.where(valid, a.row_of_slot(), a.n_rows)
    cols = jnp.where(valid, a.col_idx, 0)
    v = jnp.where(valid, a.values[0].astype(jnp.float32), 0.0)
    g = d[cols] * (v[:, None] if d.ndim == 2 else v)
    out = jax.ops.segment_sum(
        g, rows, num_segments=a.n_rows + 1, indices_are_sorted=True
    )
    return out[: a.n_rows]


def dense_to_csr(c_dense, sr, capacity: Optional[int] = None) -> SparseCSR:
    """Host-side dense f32 -> SparseCSR on `sr` (validation/extraction)."""
    d = np.asarray(jax.device_get(c_dense))
    r, cc = np.nonzero(d)
    vals = np.round(d[r, cc]).astype(np.uint64) if sr.name != "f32" else d[r, cc]
    return SparseCSR.from_coo(
        r, cc, vals, d.shape[0], d.shape[1], sr=sr,
        capacity=capacity or max(len(r), 1),
    )


@jax.jit
def spmm_csr_dense_exact(a: SparseCSR, d_limbs):
    """C = A x D on the exact saturating integer semiring (u32/u64 limb
    tuples) — the SpMM lowering for integer einsum specs the f32 carrier
    cannot serve (reference VM handles integer semirings uniformly,
    linalg/src/einsum.rs:38-85).

    Gather D rows by A's columns, saturating-multiply by A's entry values,
    then segment-sum by row as MODULAR 16-bit plane sums recombined with
    saturation (segments._recombine_sat16): the saturating fold of
    non-negative values equals min(true sum, MAX), so exact plane sums
    suffice.  Exact while every row's entry count < 2^16; returns
    (limbs, exact_ok) and the caller must not use limbs when ~exact_ok —
    the framework's loud-failure discipline.
    """
    from . import segments

    sr = a.sr
    valid = jnp.arange(a.capacity) < a.nnz
    rows = jnp.where(valid, a.row_of_slot(), a.n_rows)
    cols = jnp.where(valid, jnp.clip(a.col_idx, 0, a.n_cols - 1), 0)
    g = tuple(l[cols] for l in d_limbs)                    # (cap, m) limbs
    av = tuple(l[:, None] for l in a.values)
    prod = sr.mul(av, g)
    prod = tuple(jnp.where(valid[:, None], l, 0) for l in prod)
    m16 = jnp.uint32(0xFFFF)
    planes = []
    for limb in prod:
        planes.append(limb & m16)
        planes.append(limb >> 16)
    n_seg = a.n_rows + 1
    sums = [
        jax.ops.segment_sum(p, rows, num_segments=n_seg,
                            indices_are_sorted=True)[: a.n_rows]
        for p in planes
    ]
    out = segments._recombine_sat16(sr, sums)
    # plane exactness: a 16-bit plane of 2^16 max-valued terms wraps uint32
    exact_ok = jnp.max(a.row_nnz()) < 0xFFFF
    return out, exact_ok
