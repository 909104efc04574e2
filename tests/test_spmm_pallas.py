"""Dense-accumulator row SpMM (kernels/spmm_pallas.py): interpret-mode
differential tests vs numpy, the wrapper's padding and guards, the
interpret-mode helper, plus host-side CSR builder agreement."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sparsetpu import SparseCSR, U64, F32SR
from sparsetpu.graphs import generate
from sparsetpu.kernels import spmm_pallas as sp
from sparsetpu.semiring import U32


def _torus(dims, density, seed):
    coo = generate.lattice(list(dims), torus=True)
    coo = generate.thin(coo, density, seed=seed)
    rows, cols, vals, n = coo
    return SparseCSR.from_coo(rows, cols, vals, n, sr=U64)


def _spmm_np(a, p_np):
    """Run the kernel on an unpadded P and return the unpadded result."""
    out = sp.spmm_pallas(*sp.csr_operand(a), sp.pad_cols(jnp.asarray(p_np)))
    return np.asarray(jax.device_get(out))[:, : p_np.shape[1]]


@pytest.mark.parametrize("dims,m", [([4, 4, 4], 64), ([8, 8], 100),
                                    ([4, 4], 1500)])
def test_spmm_pallas_matches_numpy(dims, m):
    a = _torus(dims, 0.4, seed=dims[0])
    n = a.n_rows
    ad = a.to_dense_numpy().astype(np.float64)
    rng = np.random.default_rng(0)
    p_np = rng.integers(0, 5, size=(n, m)).astype(np.float32)
    want = (ad @ p_np.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(_spmm_np(a, p_np), want)


def test_spmm_pallas_chain_matches_dense_chain():
    from sparsetpu.bench.chain import host_f32_dense

    a = _torus([4, 4, 4], 0.3, seed=7)
    n = a.n_rows
    op = sp.csr_operand(a)
    ad = host_f32_dense(a).astype(np.float64)
    p = sp.pad_cols(jnp.asarray(ad, jnp.float32))
    want = ad.copy()
    for _ in range(3):  # A^2..A^4
        c = sp.spmm_pallas(*op, p)
        want = ad @ want
        got = np.asarray(jax.device_get(c))[:, :n]
        np.testing.assert_array_equal(got, want.astype(np.float32))
        p = c


def test_value_bound_guard():
    a = SparseCSR.from_coo([0], [0], [1 << 24], 8, 8, sr=U64)
    with pytest.raises(ValueError):
        sp.csr_operand(a)


def _case_matrix(case):
    """(rows, cols, vals, n_rows, n_cols, semiring) for one wrapper case."""
    rng = np.random.default_rng(hash(case) % 2**32)
    if case == "empty_rows":
        # rows 0, 3 and the last two hold no entries
        r = np.array([1, 1, 2, 4, 4, 4, 5])
        c = np.array([0, 5, 2, 1, 3, 6, 7])
        return r, c, rng.integers(1, 9, 7), 8, 8, U64
    if case == "hub_row":
        # row 2 references every column; the rest hold one entry each
        n = 40
        r = np.concatenate([np.full(n, 2), np.arange(n)])
        c = np.concatenate([np.arange(n), (np.arange(n) * 7) % n])
        return r, c, rng.integers(1, 5, 2 * n), n, n, U64
    if case == "all_empty":
        return np.array([], int), np.array([], int), np.array([], int), 6, 6, U64
    n = 30
    r, c = rng.integers(0, n, 90), rng.integers(0, n, 90)
    if case == "u32":
        return r, c, rng.integers(1, 9, 90), n, n, U32
    if case == "f32":
        return r, c, rng.standard_normal(90).astype(np.float32), n, n, F32SR
    if case == "rect":
        return r, c % 17, rng.integers(1, 9, 90), n, 17, U64
    raise ValueError(case)


@pytest.mark.parametrize("case,m", [
    ("empty_rows", 5), ("hub_row", 1000), ("all_empty", 3), ("u32", 1025),
    ("f32", 257), ("rect", 2049), ("u32", 1), ("hub_row", 130)])
def test_spmm_pallas_wrapper_cases(case, m):
    """Empty rows, a hub row, widths that are not a multiple of the block,
    u32/u64/f32 semirings and a rectangular A against float64 numpy."""
    r, c, v, n_rows, n_cols, sr = _case_matrix(case)
    a = SparseCSR.from_coo_host(r, c, v, n_rows, n_cols, sr=sr)
    ad = a.to_dense_numpy().astype(np.float64)
    rng = np.random.default_rng(m)
    if sr is F32SR:
        p_np = rng.standard_normal((n_cols, m)).astype(np.float32)
        np.testing.assert_allclose(_spmm_np(a, p_np), ad @ p_np,
                                   rtol=1e-5, atol=1e-5)
    else:
        p_np = rng.integers(0, 7, size=(n_cols, m)).astype(np.float32)
        np.testing.assert_array_equal(_spmm_np(a, p_np),
                                      (ad @ p_np).astype(np.float32))


@pytest.mark.parametrize("sr", [U32, U64])
def test_value_bound_guard_semirings(sr):
    """Integer values at 2^24 leave the f32 carrier's exact range; just
    below it they are accepted."""
    big = SparseCSR.from_coo_host([0, 1], [1, 0], [1 << 24, 3], 2, sr=sr)
    with pytest.raises(ValueError, match="2\\^24"):
        sp.csr_operand(big)
    ok = SparseCSR.from_coo_host([0, 1], [1, 0], [(1 << 24) - 1, 3], 2, sr=sr)
    assert float(sp.csr_operand(ok)[2].max()) == float((1 << 24) - 1)


def test_f32_semiring_has_no_value_bound():
    a = SparseCSR.from_coo_host([0], [0], [float(1 << 30)], 2, sr=F32SR)
    assert float(sp.csr_operand(a)[2][0]) == float(1 << 30)


@pytest.mark.parametrize("m,block,width", [
    (1, 1, 1), (3, 4, 4), (100, 128, 128), (1024, 1024, 1024),
    (1025, 1024, 2048), (27000, 1024, 27648)])
def test_block_and_padding(m, block, width):
    assert sp.block_for(m) == block
    assert sp.padded_width(m) == width
    assert sp.pad_cols(jnp.ones((2, m))).shape == (2, width)


def test_unpadded_width_rejected():
    a = _torus([4, 4], 0.5, seed=1)
    with pytest.raises(ValueError, match="pad_cols"):
        sp.spmm_pallas(*sp.csr_operand(a), jnp.ones((a.n_cols, 1500)))


class TestInterpretHelper:
    def test_cpu_interprets(self):
        from sparsetpu.kernels import interpret

        assert jax.default_backend() == "cpu"
        assert interpret() is True

    def test_gpu_compiles(self, monkeypatch):
        from sparsetpu import kernels

        monkeypatch.setattr(kernels.jax, "default_backend", lambda: "gpu")
        assert kernels.interpret() is False

    @pytest.mark.parametrize("backend", ["rocm", "METAL", "neuron"])
    def test_other_backend_raises(self, monkeypatch, backend):
        from sparsetpu import kernels

        monkeypatch.setattr(kernels.jax, "default_backend", lambda: backend)
        with pytest.raises(RuntimeError, match="no Pallas route"):
            kernels.interpret()


class TestFromCooHost:
    def test_matches_device_build(self):
        coo = generate.lattice([5, 5], torus=True)
        rows, cols, vals, n = coo
        dev = SparseCSR.from_coo(rows, cols, vals, n, sr=U64)
        host = SparseCSR.from_coo_host(rows, cols, vals, n, sr=U64)
        np.testing.assert_array_equal(host.to_dense_numpy(), dev.to_dense_numpy())
        np.testing.assert_array_equal(
            np.asarray(host.row_ptr), np.asarray(dev.row_ptr)
        )
        assert int(host.nnz) == int(dev.nnz)

    def test_duplicate_merge_and_saturation(self):
        big = (1 << 63) + (1 << 63) - 1  # saturates to u64 max when doubled
        h = SparseCSR.from_coo_host(
            [0, 0, 1], [1, 1, 0], [1 << 63, 1 << 63, 5], 2, sr=U64
        )
        d = h.to_dense_numpy()
        assert d[0, 1] == 0xFFFFFFFFFFFFFFFF
        assert d[1, 0] == 5

    def test_zero_filtering_and_empty(self):
        h = SparseCSR.from_coo_host([0], [0], [0], 3, sr=U64)
        assert int(h.nnz) == 0
        e = SparseCSR.from_coo_host([], [], [], 3, sr=U64)
        assert int(e.nnz) == 0

    def test_f32(self):
        h = SparseCSR.from_coo_host([0, 1], [1, 0], [1.5, -2.0], 2, sr=F32SR)
        d = h.to_dense_numpy()
        assert d[0, 1] == np.float32(1.5) and d[1, 0] == np.float32(-2.0)
