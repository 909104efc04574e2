"""Dense-accumulator SpMM chain kernel tests: exact agreement with ESC."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparsetpu import SparseCSR, U64, spgemm_auto
from sparsetpu.bench.chain import run_chain_pallas, tuple_to_f32_dense
from sparsetpu.graphs import generate
from sparsetpu.kernels import spmm_pallas as sp
from sparsetpu.ops.spmm import dense_to_csr


def _dev(coo):
    rows, cols, vals, n = coo
    return SparseCSR.from_coo(rows, cols, vals, n, sr=U64)


def _square(a):
    """A x A through the row kernel, back as an unpadded dense matrix."""
    c = sp.spmm_pallas(*sp.csr_operand(a), sp.pad_cols(tuple_to_f32_dense(a)))
    return np.asarray(jax.device_get(c))[:, : a.n_cols]


def test_spmm_matches_esc():
    coo = generate.lattice([4, 4, 4], torus=True)
    coo = generate.thin(coo, 0.5, seed=1)
    a = _dev(coo)
    # numpy int64 oracle (exact here) instead of compiling the ESC stack
    ad = a.to_dense_numpy().astype(np.int64)
    got = dense_to_csr(jnp.asarray(_square(a)), U64)
    np.testing.assert_array_equal(got.to_dense_numpy().astype(np.int64),
                                  ad @ ad)


def test_spmm_chain_matches_esc():
    coo = generate.lattice([3, 3, 3], torus=True)
    a = _dev(coo)
    results = run_chain_pallas(a, max_step=4, iters=1, reps=1, verbose=False)
    ad = a.to_dense_numpy().astype(np.int64)
    cur = ad
    for rec in results:
        cur = cur @ ad
        assert rec.nnz == int((cur != 0).sum()), rec.step


def test_spmm_rejects_huge_values():
    a = SparseCSR.from_coo([0], [1], [1 << 25], 2, sr=U64)
    with pytest.raises(ValueError, match="2\\^24"):
        sp.csr_operand(a)


def test_spmm_uneven_chunks():
    # n not a multiple of the column block; empty rows in the tail
    coo = generate.random_graph(23, 60, seed=9)
    a = _dev(coo)
    want = spgemm_auto(a, a)
    got = dense_to_csr(jnp.asarray(_square(a)), U64)
    np.testing.assert_array_equal(got.to_dense_numpy(), want.to_dense_numpy())
