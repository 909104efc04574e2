"""Attention-score kernels: `bhqd,bhkd->bhqk` dense and sparse.

Reference semantics (src/dense.rs:21-52, src/main.rs:44-120): raw Q.K^T
scores at GPT-2 shapes — no softmax, no mask, no V aggregation.  Tensors are
(batch, seq, heads, head_dim); the contraction is over head_dim per
(batch, seq) pair, giving (batch, seq, heads, heads) scores.

Dense path: one jnp.einsum, a batched GEMM (the analog of the reference's
cblas_sgemm_batch_strided FFI, src/dense.rs:105-160), at HIGHEST precision:
a GPU may otherwise run an f32 matmul in TF32, too loose for the
reference's 1e-4 agreement bound.

Sparse path: element-sparse Q/K (the capability the reference covers with
PathMap tries, src/sparse.rs:156-197) is computed as a *batched SpGEMM*
C[g] = Q[g] x K[g]^T over the flattened group axis g=(batch,seq), lowered
onto the same ESC machinery as SpGEMM by embedding groups block-diagonally
in the index space.  Work scales with matched nonzeros, reproducing the
sparse-vs-dense tipover methodology.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..csr import SparseCSR
from ..ops.spgemm import spgemm, symbolic_flops
from ..semiring import F32SR


def attention_flops(shape: Tuple[int, int, int, int]) -> int:
    """Multiply count of the dense kernel (reference RCOUNT, src/dense.rs:28-51)."""
    b, s, h, d = shape
    return b * s * h * h * d


def attention_scores_dense(q: jnp.ndarray, k: jnp.ndarray) -> jnp.ndarray:
    """(b, s, h, d), (b, s, h, d) -> (b, s, h, h), full f32 products."""
    return jnp.einsum(
        "bshd,bsgd->bshg", q, k, precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32
    )


attention_scores_dense_jit = jax.jit(attention_scores_dense)


# ---------------------------------------------------------------------------
# element-sparse tensors as grouped CSR
# ---------------------------------------------------------------------------

def random_sparse_tensor(shape, density: float, seed: int, scale: float = 1.0):
    """Dense numpy tensor with ~density fraction nonzero (reference
    FromRng::with_density, src/traits.rs:40-42)."""
    rng = np.random.default_rng(seed)
    mask = rng.random(shape) < density
    vals = (rng.random(shape, dtype=np.float32) * 2.0 - 1.0) * scale
    return np.where(mask, vals, 0.0).astype(np.float32)


def tensor_to_grouped_csr(x: np.ndarray, transpose_last: bool = False,
                          capacity: Optional[int] = None) -> SparseCSR:
    """(b, s, h, d) tensor -> block-diagonal CSR over groups g=(b*s).

    Rows are (g, h) flattened [compound rows, the v2-Csr idea,
    linalg/src/csr.rs:87-98]; columns are (g, d) flattened so that distinct
    groups never interact — a single SpGEMM then computes every group's
    Q[g] x K[g]^T product.  ``transpose_last`` swaps (h, d) to build K^T.
    """
    b, s, h, d = x.shape
    g = b * s
    xg = x.reshape(g, h, d)
    if transpose_last:
        xg = np.swapaxes(xg, 1, 2)
        h, d = d, h
    gi, hi, di = np.nonzero(xg)
    rows = gi.astype(np.int64) * h + hi
    cols = gi.astype(np.int64) * d + di
    vals = xg[gi, hi, di]
    cap = capacity or max(len(rows), 1)
    # host-side build: the sweep constructs two fresh CSRs per density
    # step, and a device COO sort would compile once per capacity
    return SparseCSR.from_coo_host(
        rows, cols, vals, g * h, g * d, sr=F32SR, capacity=cap
    )


def attention_scores_sparse(q_csr: SparseCSR, kt_csr: SparseCSR,
                            expand_cap: int, out_cap: Optional[int] = None) -> SparseCSR:
    """Sparse scores = Q_grouped x K^T_grouped (one batched ESC SpGEMM)."""
    return spgemm(q_csr, kt_csr, expand_cap, out_cap)


def sparse_scores_to_dense(c: SparseCSR, shape) -> np.ndarray:
    """(g*h, g*h) block-diag sparse scores -> (b, s, h, h) dense numpy."""
    b, s, h, _ = shape
    g = b * s
    dense = np.zeros((b * s * h, h), np.float32)
    row_ptr, col_idx, vals = c.to_numpy()
    rows = np.repeat(np.arange(c.n_rows), np.diff(row_ptr))
    grp = rows // h
    kh = col_idx - grp * h
    dense[rows, kh] = vals
    return dense.reshape(b, s, h, h)
