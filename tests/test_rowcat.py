"""Row-categorized SpGEMM (ops/rowcat.py): agreement vs the ESC kernel and
the exact Python oracle across uniform, skewed, rectangular, and saturating
inputs — the reference cross-validation discipline
(src/graph_magnus.rs:859-881) applied to the vectorized MAGNUS re-design."""

import numpy as np
import pytest

from sparsetpu import SparseCSR, U64, F32SR, spgemm_auto
from sparsetpu.graphs import datasets, generate
from sparsetpu.ops.rowcat import plan, spgemm_rowcat
from sparsetpu.utils import oracle


def _csr(coo, sr=U64):
    rows, cols, vals, n = coo
    return SparseCSR.from_coo(rows, cols, vals, n, sr=sr)


def _assert_equal(got: SparseCSR, want: SparseCSR):
    np.testing.assert_array_equal(got.to_dense_numpy(), want.to_dense_numpy())
    assert int(got.nnz) == int(want.nnz)


def test_rowcat_matches_oracle_random():
    coo = generate.random_graph(60, 300, seed=0)
    a = _csr(coo)
    got = spgemm_rowcat(a, a).check()
    want = oracle.matmul(oracle.coo_to_dict(coo), oracle.coo_to_dict(coo))
    row_ptr, col_idx, vals = got.to_numpy()
    rows = np.repeat(np.arange(got.n_rows), np.diff(row_ptr))
    got_d = {(int(r), int(c)): int(v) for r, c, v in zip(rows, col_idx, vals)}
    assert got_d == want


def test_rowcat_matches_esc_torus():
    coo = generate.lattice([4, 4, 4], torus=True)
    a = _csr(coo)
    _assert_equal(spgemm_rowcat(a, a).check(), spgemm_auto(a, a))


def test_rowcat_power_law_multi_category():
    # skewed degrees: hub rows land in larger-L categories than tail rows
    coo = datasets.power_law(400, m_per_node=6, seed=3)
    a = _csr(coo)
    fr, cat, perm, stats = plan(a, a)
    n_nonempty = int(np.sum(np.asarray(stats)[:, 0] > 0))
    assert n_nonempty >= 2, "power-law must exercise multiple categories"
    _assert_equal(spgemm_rowcat(a, a).check(), spgemm_auto(a, a))


def test_rowcat_rectangular():
    rng = np.random.default_rng(5)
    a = SparseCSR.from_coo(rng.integers(0, 30, 90), rng.integers(0, 50, 90),
                           rng.integers(1, 4, 90).astype(np.uint64), 30, 50,
                           sr=U64)
    b = SparseCSR.from_coo(rng.integers(0, 50, 80), rng.integers(0, 20, 80),
                           rng.integers(1, 4, 80).astype(np.uint64), 50, 20,
                           sr=U64)
    _assert_equal(spgemm_rowcat(a, b).check(), spgemm_auto(a, b))


def test_rowcat_empty_rows_and_chain():
    # chain squaring: values grow, zero rows appear after thinning
    coo = generate.lattice([5, 5], torus=True)
    coo = generate.thin(coo, 0.4, seed=1)
    a = _csr(coo)
    c1 = spgemm_rowcat(a, a).check()
    c2 = spgemm_rowcat(c1, a).check()
    w1 = spgemm_auto(a, a)
    w2 = spgemm_auto(w1, a)
    _assert_equal(c2, w2)


def test_rowcat_saturation():
    big = np.uint64((1 << 63) + 11)
    a = SparseCSR.from_coo(
        np.array([0, 0, 1]), np.array([0, 1, 0]),
        np.array([big, 7, 3], np.uint64), 2, sr=U64,
    )
    got = spgemm_rowcat(a, a).check()
    want = spgemm_auto(a, a)
    _assert_equal(got, want)


def test_rowcat_f32():
    rng = np.random.default_rng(7)
    a = SparseCSR.from_coo(rng.integers(0, 20, 60), rng.integers(0, 20, 60),
                           rng.standard_normal(60).astype(np.float32), 20,
                           sr=F32SR)
    got = spgemm_rowcat(a, a).check()
    want = a.to_dense_numpy() @ a.to_dense_numpy()
    np.testing.assert_allclose(got.to_dense_numpy(), want, rtol=1e-5,
                               atol=1e-6)


def test_rowcat_identity():
    a = SparseCSR.identity(12)
    _assert_equal(spgemm_rowcat(a, a).check(), a)


def test_rowcat_overflow_row_via_esc():
    """A hub row whose product count exceeds the largest slab threshold
    must route through the internal ESC fallback and still agree."""
    rng = np.random.default_rng(11)
    n = 400
    hub_cols = rng.choice(n, 300, replace=False)
    rows = [np.zeros(300, np.int64)]
    cols = [hub_cols.astype(np.int64)]
    # referenced B-rows dense enough that fr[hub] = 300*260 > 65536
    for k in hub_cols:
        rows.append(np.full(260, k, np.int64))
        cols.append(rng.choice(n, 260, replace=False).astype(np.int64))
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    v = np.ones(len(r), np.uint64)
    a = SparseCSR.from_coo(r, c, v, n, sr=U64)
    fr, cat, perm, stats = plan(a, a)
    assert int(np.asarray(stats)[-1, 0]) >= 1  # overflow category non-empty
    got = spgemm_rowcat(a, a).check()
    # numpy int64 oracle: compiling a second full kernel stack (ESC at a
    # ~160k cap) just to produce `want` cost ~300 s of XLA:CPU compile
    ad = a.to_dense_numpy().astype(np.int64)
    np.testing.assert_array_equal(got.to_dense_numpy().astype(np.int64),
                                  ad @ ad)


def test_rowcat_unfused_agrees():
    """fused=False (the compile-bounded large-shape path) must agree."""
    coo = datasets.power_law(350, m_per_node=6, seed=5)
    a = _csr(coo)
    got = spgemm_rowcat(a, a, fused=False).check()
    want = spgemm_rowcat(a, a, fused=True).check()
    _assert_equal(got, want)
