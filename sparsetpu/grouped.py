"""Batched (compound-row) sparse tensors: the v2-Csr generalization.

The reference's linalg Csr walks *compound rows* — flattened leading axes —
so batched specs like ``bij,bjk->bik`` iterate the sparse (b, i) row
natively (linalg/src/csr.rs:87-98, linalg/src/einsum.rs:209-232).  Here
the same idea is an *embedding*: a (g, n, m) batched sparse tensor is a
block-diagonal SparseCSR of shape (g*n, g*m), where distinct batch entries
can never interact, so one flat SpGEMM computes every batch's product.
This is also how sparse attention is lowered (attention/scores.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .csr import SparseCSR
from .ops.spgemm import spgemm, symbolic_flops
from .semiring import Semiring, U64


@dataclasses.dataclass(frozen=True)
class GroupedCSR:
    """(g, n, m) batched sparse tensor as a block-diagonal SparseCSR."""

    flat: SparseCSR
    g: int
    n: int
    m: int

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.g, self.n, self.m)

    @staticmethod
    def from_coo(batch, rows, cols, vals, g: int, n: int, m: int,
                 sr: Semiring = U64, capacity: Optional[int] = None) -> "GroupedCSR":
        batch = np.asarray(batch, np.int64)
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        flat = SparseCSR.from_coo(
            batch * n + rows, batch * m + cols, vals, g * n, g * m,
            sr=sr, capacity=capacity,
        )
        return GroupedCSR(flat, g, n, m)

    @staticmethod
    def from_dense(x, sr: Semiring = U64, capacity: Optional[int] = None) -> "GroupedCSR":
        x = np.asarray(x)
        assert x.ndim == 3
        g, n, m = x.shape
        b, r, c = np.nonzero(x)
        return GroupedCSR.from_coo(b, r, c, x[b, r, c], g, n, m, sr, capacity)

    def to_dense(self) -> np.ndarray:
        d = self.flat.to_dense_numpy()
        out = np.zeros((self.g, self.n, self.m), d.dtype)
        for gg in range(self.g):
            out[gg] = d[gg * self.n:(gg + 1) * self.n,
                        gg * self.m:(gg + 1) * self.m]
        return out

    def matmul(self, other: "GroupedCSR") -> "GroupedCSR":
        """Batched C[g] = A[g] x B[g] as ONE flat SpGEMM (block-diagonal
        operands never cross batches)."""
        assert self.g == other.g and self.m == other.n
        flops = int(symbolic_flops(self.flat, other.flat))
        cap = 1 << (max(flops, 1) - 1).bit_length()
        c = spgemm(self.flat, other.flat, cap).check()
        return GroupedCSR(c, self.g, self.n, other.m)

    def transpose(self) -> "GroupedCSR":
        return GroupedCSR(self.flat.transpose(), self.g, self.m, self.n)
