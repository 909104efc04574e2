"""Tests that need an NVIDIA GPU: the compiled (not interpreted) row SpMM
kernel and the full-precision f32 matmul sites on the card.  They skip
elsewhere; run them on a card with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import numpy as np
import pytest

import jax.numpy as jnp

from sparsetpu import SparseCSR
from sparsetpu.graphs.generate import random_graph

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("n,edges,m", [(300, 2000, 100), (2000, 30000, 1500),
                                       (64, 4000, 3000)])
def test_row_spmm_compiled_matches_numpy(gpu, n, edges, m):
    from sparsetpu.kernels import interpret, spmm_pallas as sp

    assert interpret() is False
    a = SparseCSR.from_coo_host(*random_graph(n, edges, seed=n))
    rng = np.random.default_rng(m)
    p = rng.integers(0, 7, size=(n, m)).astype(np.float32)
    got = sp.spmm_pallas(*sp.csr_operand(a), sp.pad_cols(jnp.asarray(p)))
    want = a.to_dense_numpy().astype(np.float64) @ p
    np.testing.assert_array_equal(np.asarray(got)[:, :m], want)


def test_attention_scores_full_precision(gpu):
    from sparsetpu.attention import scores

    rng = np.random.default_rng(0)
    q = rng.standard_normal((4, 256, 12, 64)).astype(np.float32)
    k = rng.standard_normal((4, 256, 12, 64)).astype(np.float32)
    got = np.asarray(scores.attention_scores_dense_jit(q, k))
    want = np.einsum("bshd,bsgd->bshg", q.astype(np.float64),
                     k.astype(np.float64))
    # TF32 would miss this bound by ~three orders of magnitude
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def test_dense_dense_exact_on_card(gpu):
    import scipy.sparse as ss

    from sparsetpu.ops.denseacc import spgemm_dense_dense

    r, c, v, n = random_graph(1024, 20000, seed=5)
    v = (v % 200 + 1).astype(np.uint64)
    a = SparseCSR.from_coo_host(r, c, v, n)
    s = ss.coo_matrix((v.astype(np.int64), (r, c)), shape=(n, n)).tocsr()
    want = (s @ s).toarray()
    assert want.max() < (1 << 24)
    out = spgemm_dense_dense(a, a).check()
    np.testing.assert_array_equal(out.to_dense_numpy().astype(np.int64), want)
    wide = spgemm_dense_dense(a, a, wide=True).check()
    np.testing.assert_array_equal(wide.to_dense_numpy().astype(np.int64), want)
