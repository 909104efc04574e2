"""Dense-accumulator SpGEMM (ops/denseacc.py) vs scipy, exact u64 counts.

The tier-2 agreement battery (SURVEY §4.2): same questions as the other
SpGEMM kernels — torus, ER, non-8-divisible rows, rectangular-compatible
pair, overflow poisoning."""

import numpy as np
import pytest
import scipy.sparse as ss

from sparsetpu.csr import SparseCSR
from sparsetpu.graphs.generate import lattice, random_graph
from sparsetpu.ops.denseacc import spgemm_dense_acc


def _scipy_csr(coo):
    r, c, v, n = coo
    return ss.coo_matrix((v.astype(np.int64), (r, c)), shape=(n, n)).tocsr()


@pytest.mark.parametrize(
    "coo",
    [lattice((5, 5, 5), True), random_graph(100, 700, seed=3),
     random_graph(123, 700, seed=4)],
    ids=["torus555", "er100", "er123-nondiv8"],
)
def test_dense_acc_matches_scipy(coo):
    r, c, v, n = coo
    a = SparseCSR.from_coo_host(r, c, v, n)
    out = spgemm_dense_acc(a, a).check()
    sc = _scipy_csr(coo) @ _scipy_csr(coo)
    assert int(out.nnz) == sc.nnz
    assert np.array_equal(out.to_dense_numpy().astype(np.int64), sc.toarray())


def test_dense_acc_pair():
    ca = random_graph(64, 300, seed=5)
    cb = random_graph(64, 500, seed=6)
    a = SparseCSR.from_coo_host(*ca)
    b = SparseCSR.from_coo_host(*cb)
    out = spgemm_dense_acc(a, b).check()
    assert np.array_equal(
        out.to_dense_numpy().astype(np.int64),
        (_scipy_csr(ca) @ _scipy_csr(cb)).toarray(),
    )


def test_dense_acc_undersized_cap_poisons():
    coo = random_graph(100, 700, seed=3)
    a = SparseCSR.from_coo_host(*coo)
    out = spgemm_dense_acc(a, a, out_cap=8)
    with pytest.raises(ValueError):
        out.check()


def test_dense_acc_tiled_matches_scipy():
    # n > panel width so multiple panels engage; odd n exercises row padding
    from sparsetpu.ops.denseacc import spgemm_dense_acc_tiled

    coo = random_graph(2500, 9000, seed=7)
    a = SparseCSR.from_coo_host(*coo)
    out = spgemm_dense_acc_tiled(a, a, panel_cols=1024).check()
    sc = _scipy_csr(coo) @ _scipy_csr(coo)
    assert int(out.nnz) == sc.nnz
    rp, ci, v = out.to_numpy()
    s2 = sc.sorted_indices()
    assert np.array_equal(rp, s2.indptr)
    assert np.array_equal(ci, s2.indices)
    assert np.array_equal(v.astype(np.int64), s2.data.astype(np.int64))


def test_dense_acc_tiled_pair_rectangular_panels():
    from sparsetpu.ops.denseacc import spgemm_dense_acc_tiled

    ca = random_graph(1100, 4000, seed=8)
    cb = random_graph(1100, 5000, seed=9)
    a = SparseCSR.from_coo_host(*ca)
    b = SparseCSR.from_coo_host(*cb)
    out = spgemm_dense_acc_tiled(a, b, panel_cols=1024).check()
    assert np.array_equal(
        out.to_dense_numpy().astype(np.int64),
        (_scipy_csr(ca) @ _scipy_csr(cb)).toarray(),
    )


def test_dense_acc_u32_semiring():
    from sparsetpu.semiring import U32

    coo = random_graph(100, 700, seed=11)
    r, c, v, n = coo
    a = SparseCSR.from_coo_host(r, c, v, n, sr=U32)
    out = spgemm_dense_acc(a, a).check()
    sc = _scipy_csr(coo) @ _scipy_csr(coo)
    assert int(out.nnz) == sc.nnz
    assert np.array_equal(out.to_dense_numpy().astype(np.int64), sc.toarray())


def test_dense_acc_f32_semiring():
    from sparsetpu.semiring import F32SR

    coo = random_graph(100, 700, seed=12)
    r, c, v, n = coo
    vf = (v % 7 + 1).astype(np.float32) * 0.5
    a = SparseCSR.from_coo_host(r, c, vf, n, sr=F32SR)
    out = spgemm_dense_acc(a, a).check()
    sa = ss.coo_matrix((vf.astype(np.float64), (r, c)), shape=(n, n)).tocsr()
    sc = sa @ sa
    assert int(out.nnz) == sc.nnz
    # f32 accumulation order differs from scipy f64: allclose, not equal
    np.testing.assert_allclose(
        out.to_dense_numpy(), sc.toarray(), rtol=1e-5, atol=1e-6)


def test_dense_acc_tiled_u32_f32():
    from sparsetpu.ops.denseacc import spgemm_dense_acc_tiled
    from sparsetpu.semiring import F32SR, U32

    coo = random_graph(1500, 6000, seed=13)
    r, c, v, n = coo
    a32 = SparseCSR.from_coo_host(r, c, v, n, sr=U32)
    out = spgemm_dense_acc_tiled(a32, a32, panel_cols=1024).check()
    sc = _scipy_csr(coo) @ _scipy_csr(coo)
    assert int(out.nnz) == sc.nnz
    assert np.array_equal(out.to_dense_numpy().astype(np.int64), sc.toarray())

    vf = (v % 5 + 1).astype(np.float32)
    af = SparseCSR.from_coo_host(r, c, vf, n, sr=F32SR)
    outf = spgemm_dense_acc_tiled(af, af, panel_cols=1024).check()
    sf = ss.coo_matrix((vf.astype(np.float64), (r, c)), shape=(n, n)).tocsr()
    scf = sf @ sf
    assert int(outf.nnz) == scf.nnz
    np.testing.assert_allclose(
        outf.to_dense_numpy(), scf.toarray(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "coo",
    [lattice((5, 5, 5), True), random_graph(100, 700, seed=3),
     random_graph(123, 700, seed=4)],
    ids=["torus555", "er100", "er123-nondiv8"],
)
def test_dense_dense_matches_scipy(coo):
    from sparsetpu.ops.denseacc import spgemm_dense_dense

    r, c, v, n = coo
    a = SparseCSR.from_coo_host(r, c, v, n)
    out = spgemm_dense_dense(a, a).check()
    sc = _scipy_csr(coo) @ _scipy_csr(coo)
    assert int(out.nnz) == sc.nnz
    rp, ci, vv = out.to_numpy()
    s2 = sc.sorted_indices()
    assert np.array_equal(rp, s2.indptr)
    assert np.array_equal(ci, s2.indices)
    assert np.array_equal(vv.astype(np.int64), s2.data.astype(np.int64))


def test_dense_dense_pair_rectangular():
    from sparsetpu.ops.denseacc import spgemm_dense_dense

    rng = np.random.default_rng(21)
    ra, ca_, va = rng.integers(0, 60, 200), rng.integers(0, 90, 200), \
        rng.integers(1, 5, 200)
    rb, cb_, vb = rng.integers(0, 90, 300), rng.integers(0, 40, 300), \
        rng.integers(1, 5, 300)
    sa = ss.coo_matrix((va.astype(np.int64), (ra, ca_)), shape=(60, 90)).tocsr()
    sb = ss.coo_matrix((vb.astype(np.int64), (rb, cb_)), shape=(90, 40)).tocsr()
    a = SparseCSR.from_coo(ra, ca_, va, 60, 90)
    b = SparseCSR.from_coo(rb, cb_, vb, 90, 40)
    out = spgemm_dense_dense(a, b).check()
    assert np.array_equal(out.to_dense_numpy().astype(np.int64),
                          (sa @ sb).toarray())


def test_dense_dense_value_bound_poisons():
    from sparsetpu.ops.denseacc import spgemm_dense_dense
    from sparsetpu.semiring import U64

    # inputs >= 2^16 are outside the f32 tier's admission rule: nnz must poison
    r = np.array([0, 1]); c = np.array([1, 0])
    v = np.array([1 << 16, 3], dtype=np.uint64)
    a = SparseCSR.from_coo_host(r, c, v, 2, sr=U64)
    with pytest.raises(ValueError):
        spgemm_dense_dense(a, a).check()


def test_dense_dense_u32_f32_semirings():
    from sparsetpu.ops.denseacc import spgemm_dense_dense
    from sparsetpu.semiring import F32SR, U32

    coo = random_graph(100, 700, seed=11)
    r, c, v, n = coo
    a32 = SparseCSR.from_coo_host(r, c, v, n, sr=U32)
    out = spgemm_dense_dense(a32, a32).check()
    sc = _scipy_csr(coo) @ _scipy_csr(coo)
    assert int(out.nnz) == sc.nnz
    assert np.array_equal(out.to_dense_numpy().astype(np.int64), sc.toarray())

    vf = (v % 7 + 1).astype(np.float32) * 0.5
    af = SparseCSR.from_coo_host(r, c, vf, n, sr=F32SR)
    outf = spgemm_dense_dense(af, af).check()
    sf = ss.coo_matrix((vf.astype(np.float64), (r, c)), shape=(n, n)).tocsr()
    scf = sf @ sf
    assert int(outf.nnz) == scf.nnz
    np.testing.assert_allclose(
        outf.to_dense_numpy(), scf.toarray(), rtol=1e-5, atol=1e-6)


def test_auto_routes_densedense_and_falls_back():
    from sparsetpu.ops.spgemm import spgemm_auto

    # products large vs n^2: the cost model must pick the dense route and
    # the result must stay exact vs scipy
    coo = random_graph(200, 4000, seed=31)
    a = SparseCSR.from_coo_host(*coo)
    out = spgemm_auto(a, a)
    sc = _scipy_csr(coo) @ _scipy_csr(coo)
    assert int(out.nnz) == sc.nnz
    assert np.array_equal(out.to_dense_numpy().astype(np.int64), sc.toarray())

    # values >= 2^16 poison the dense-dense route on device; auto must
    # fall back to a sort path and still return the exact result
    r, c, v, n = coo
    v2 = v.astype(np.uint64) * (1 << 20)
    a2 = SparseCSR.from_coo_host(r, c, v2, n)
    out2 = spgemm_auto(a2, a2)
    sc2 = ss.coo_matrix((v2.astype(np.int64), (r, c)), shape=(n, n)).tocsr()
    ref = sc2 @ sc2
    assert int(out2.nnz) == ref.nnz
    assert np.array_equal(
        out2.to_dense_numpy().astype(np.int64), ref.toarray())


def test_dense_dense_wide_i32_tier():
    from sparsetpu.ops.denseacc import spgemm_dense_dense
    from sparsetpu.ops.spgemm import spgemm_auto

    # outputs in [2^24, 2^30) (the f32 tier's output check poisons): the
    # int32 tier must produce the exact result, and auto must route
    # through it
    coo = random_graph(150, 900, seed=41)
    r, c, v, n = coo
    v2 = (v.astype(np.uint64) % 7 + 1) * 1200
    a = SparseCSR.from_coo_host(r, c, v2, n)
    sc = ss.coo_matrix((v2.astype(np.int64), (r, c)), shape=(n, n)).tocsr()
    ref = sc @ sc
    assert int(ref.max()) < (1 << 30) and int(ref.max()) >= (1 << 24)
    with pytest.raises(ValueError):
        spgemm_dense_dense(a, a).check()  # f32 tier correctly refuses
    out = spgemm_dense_dense(a, a, wide=True).check()
    assert int(out.nnz) == ref.nnz
    assert np.array_equal(out.to_dense_numpy().astype(np.int64),
                          ref.toarray())
    out2 = spgemm_auto(a, a)
    assert np.array_equal(out2.to_dense_numpy().astype(np.int64),
                          ref.toarray())


def test_dense_dense_wide_overflow_poisons():
    from sparsetpu.ops.denseacc import spgemm_dense_dense

    # outputs past 2^30: the magnitude companion must poison
    r = np.array([0, 0, 1, 1]); c = np.array([0, 1, 0, 1])
    v = np.full(4, 1 << 16, dtype=np.uint64)
    a = SparseCSR.from_coo_host(r, c, v, 2)
    with pytest.raises(ValueError):
        spgemm_dense_dense(a, a, wide=True).check()


def test_dense_dense_tiled_matches_scipy():
    from sparsetpu.ops.denseacc import spgemm_dense_dense_tiled

    # n > panel width so multiple panels engage; odd n exercises edges
    coo = random_graph(2500, 9000, seed=7)
    a = SparseCSR.from_coo_host(*coo)
    out = spgemm_dense_dense_tiled(a, a, panel_cols=1024).check()
    sc = _scipy_csr(coo) @ _scipy_csr(coo)
    assert int(out.nnz) == sc.nnz
    rp, ci, v = out.to_numpy()
    s2 = sc.sorted_indices()
    assert np.array_equal(rp, s2.indptr)
    assert np.array_equal(ci, s2.indices)
    assert np.array_equal(v.astype(np.int64), s2.data.astype(np.int64))


def test_dense_dense_tiled_pair_rectangular():
    from sparsetpu.ops.denseacc import spgemm_dense_dense_tiled

    ca = random_graph(1100, 4000, seed=8)
    cb = random_graph(1100, 5000, seed=9)
    a = SparseCSR.from_coo_host(*ca)
    b = SparseCSR.from_coo_host(*cb)
    out = spgemm_dense_dense_tiled(a, b, panel_cols=1024).check()
    assert np.array_equal(
        out.to_dense_numpy().astype(np.int64),
        (_scipy_csr(ca) @ _scipy_csr(cb)).toarray(),
    )


def test_dense_dense_tiled_value_bound_poisons():
    from sparsetpu.ops.denseacc import spgemm_dense_dense_tiled

    r = np.array([0, 1]); c = np.array([1, 0])
    v = np.array([1 << 16, 3], dtype=np.uint64)
    a = SparseCSR.from_coo_host(r, c, v, 2)
    with pytest.raises(ValueError):
        spgemm_dense_dense_tiled(a, a, panel_cols=1024).check()
