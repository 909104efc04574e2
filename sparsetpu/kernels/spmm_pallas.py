"""Row-streaming dense-accumulator SpMM C = A x P: a Pallas kernel on the
Triton route.

The chain's hot step is C[i, :] += A[i, k] * P[k, :] — per A entry, one P
row is read and added into one C row.  A gather + segment_sum formulation
writes and re-reads the gathered (nnz, m) intermediate; this kernel moves
only the algorithm's minimum bytes (each referenced P row block read once,
C written once).  It is the analog of the reference's per-row dense-scratch
Gustavson loop (src/graph_csr.rs:306-346).

One program per (output row i, column block j): it walks row i's CSR
entries with a dynamic loop bound, loads block j of each referenced P row,
and accumulates in registers.  P's width must be a multiple of the block:
callers keep P column-padded (:func:`pad_cols`), once per chain.

Exactness: integer semirings ride an f32 carrier; products and sums are
exact while every value stays < 2^24 (callers check the maximum).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from . import interpret

BLOCK = 1024  # widest column block; narrower P uses the next power of two
NUM_WARPS = 4
NUM_STAGES = 2


def block_for(m: int) -> int:
    """Column block for a P of width m: a power of two, at most BLOCK."""
    return min(BLOCK, 1 << (max(int(m), 1) - 1).bit_length())


def padded_width(m: int) -> int:
    b = block_for(m)
    return -(-m // b) * b


def pad_cols(p: jnp.ndarray) -> jnp.ndarray:
    """Dense (k, m) -> (k, padded_width(m)) f32 with zero columns."""
    m = p.shape[1]
    p = jnp.asarray(p, jnp.float32)
    return jnp.pad(p, ((0, 0), (0, padded_width(m) - m)))


def csr_operand(a):
    """Device (row_ptr i32, col_idx i32, vals f32) of the static sparse
    operand A.  Integer semirings must hold values < 2^24 (the f32
    carrier's exact range); the f32 semiring is plain float math."""
    row_ptr, col_idx, vals = a.to_numpy()
    if (a.sr_name != "f32" and len(vals)
            and float(vals.max()) >= float(1 << 24)):
        raise ValueError("dense-accumulator spmm requires values < 2^24")
    # an empty A still gets one (never read) entry: the kernel's operands
    # may not be zero-sized
    pad = int(len(col_idx) == 0)
    return (jnp.asarray(row_ptr, jnp.int32),
            jnp.asarray(np.pad(np.asarray(col_idx, np.int32), (0, pad))),
            jnp.asarray(np.pad(np.asarray(vals).astype(np.float32), (0, pad))))


def _kernel(rp_ref, col_ref, val_ref, p_ref, o_ref, *, block: int):
    i = pl.program_id(0)
    cols = pl.ds(pl.multiple_of(pl.program_id(1) * block, block), block)

    def body(e, acc):
        return acc + val_ref[e] * p_ref[col_ref[e], cols]

    acc = jax.lax.fori_loop(rp_ref[i], rp_ref[i + 1], body,
                            jnp.zeros((block,), jnp.float32))
    o_ref[i, cols] = acc


@jax.jit
def spmm_pallas(row_ptr, col_idx, vals, p):
    """C = A x P with A from :func:`csr_operand` and P f32 (k, m), m a
    multiple of block_for(m).  Returns C f32 (n, m), directly usable as
    the next chain step's P."""
    n = row_ptr.shape[0] - 1
    m = p.shape[1]
    block = block_for(m)
    if m % block:
        raise ValueError(f"P width {m} is not a multiple of {block}; "
                         "pad it with pad_cols")
    any_spec = pl.BlockSpec(memory_space=pl.ANY)
    return pl.pallas_call(
        partial(_kernel, block=block),
        grid=(n, m // block),
        in_specs=[any_spec] * 4,
        out_specs=any_spec,
        out_shape=jax.ShapeDtypeStruct((n, m), jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret(),
        backend="triton",
        name="spmm_rows",
    )(row_ptr, col_idx, vals, p)
