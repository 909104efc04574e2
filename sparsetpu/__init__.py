"""sparsetpu — sparse linear algebra in JAX (XLA and Pallas on a GPU).

A from-scratch re-design of the capabilities of the Rust reference suite
``imlvts/sparse-linear-algebra-tests``: saturating-semiring CSR/COO, SpGEMM,
graph algorithms, block-sparse attention, a runtime einsum planner, and
row-partitioned multi-chip execution via jax.sharding.

Runnable example (the reference carries doctests on its public surface,
linalg/src/lib.rs:21-47 — same discipline here, exercised by
tests/test_doctests.py):

>>> import numpy as np
>>> from sparsetpu import SparseCSR, U64, spgemm_auto
>>> a = SparseCSR.from_coo_host([0, 0, 1], [1, 2, 2], [1, 2, 3], 3, sr=U64)
>>> c = spgemm_auto(a, a)          # A^2 on the saturating u64 semiring
>>> int(c.nnz)
1
>>> int(c.get(0, 2))               # one path 0->1->2 of weight 1*3
3
>>> from sparsetpu.ops.spgemm import spadd
>>> s = spadd(a, a)                # elementwise saturating add
>>> int(s.get(0, 2))
4
>>> bad = a.__class__.from_coo_host([0], [0], [2**63], 2, sr=U64)
>>> int(spgemm_auto(bad, bad).nnz) # 2^126 saturates to u64::MAX
1
>>> int(spgemm_auto(bad, bad).get(0, 0)) == 2**64 - 1
True
"""

from .semiring import F32SR, U32, U64, Semiring, by_name
from .csr import SparseCSR
from .ops.spgemm import spadd, spgemm, spgemm_auto, symbolic_flops

__all__ = [
    "F32SR",
    "U32",
    "U64",
    "Semiring",
    "by_name",
    "SparseCSR",
    "spadd",
    "spgemm",
    "spgemm_auto",
    "symbolic_flops",
]
