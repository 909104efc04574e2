"""chip_smoke.py: refuses to run without a GPU, and its comparison
functions accept what matches and reject what does not (tiny inputs)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as ss

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_on_cpu():
    out = _run(ROOT, "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_exits_nonzero_without_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path), "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def _csr(dense):
    m = ss.csr_matrix(np.asarray(dense, np.uint64))
    return m.indptr, m.indices, m.data


BASE = [[0, 5, 0], [7, 0, 1], [0, 0, 0]]


@pytest.mark.parametrize("other,equal", [
    (BASE, True),
    ([[0, 5, 0], [7, 0, 2], [0, 0, 0]], False),   # a value differs
    ([[5, 0, 0], [7, 0, 1], [0, 0, 0]], False),   # a column differs
    ([[0, 5, 0], [7, 0, 0], [0, 0, 1]], False),   # an entry moved rows
])
def test_csr_equal(other, equal):
    if equal:
        cs.csr_equal(_csr(other), _csr(BASE), "t")
    else:
        with pytest.raises(AssertionError):
            cs.csr_equal(_csr(other), _csr(BASE), "t")


def test_csr_equal_ignores_in_row_order():
    rp, ci, v = _csr(BASE)
    shuffled = (rp, np.array([1, 2, 0]), np.array([5, 1, 7], np.uint64))
    cs.csr_equal(shuffled, (rp, ci, v), "t")


def test_assert_close():
    want = np.array([[1.0, -2.0], [0.0, 4.0]])
    assert cs.assert_close(want + 1e-5, want, 1e-4, "t") <= 1e-4
    with pytest.raises(AssertionError):
        cs.assert_close(want + 1e-2, want, 1e-4, "t")
    with pytest.raises(AssertionError):
        cs.assert_close(np.full((2, 2), np.nan), want, 1e-4, "t")
    with pytest.raises(AssertionError):
        cs.assert_close(want[:1], want, 1e-4, "t")


def test_same_partition():
    cs.same_partition([0, 0, 1, 2], [5, 5, 3, 9], "t")
    with pytest.raises(AssertionError):
        cs.same_partition([0, 0, 1, 2], [0, 1, 1, 2], "t")


def _path_graph(n):
    r = np.concatenate([np.arange(n - 1), np.arange(1, n)])
    c = np.concatenate([np.arange(1, n), np.arange(n - 1)])
    return r, c, n


def test_graph_references_agree_with_algos():
    from sparsetpu import SparseCSR
    from sparsetpu.graphs import algos

    # a path of 5 plus a separate edge pair: diameter 4, two components
    r, c, n = _path_graph(5)
    r = np.concatenate([r, [5, 6]])
    c = np.concatenate([c, [6, 5]])
    n = 7
    adj = ss.csr_matrix((np.ones(len(r)), (r, c)), shape=(n, n))
    assert cs.diameter_reference(adj) == 4
    reach = cs.reach_reference(adj)
    assert reach[0, 4] and not reach[0, 5] and reach[0, 0]
    a = SparseCSR.from_coo_host(r, c, np.ones(len(r), np.uint64), n)
    got, _ = algos.reachability_sum(a, pattern=True)
    np.testing.assert_array_equal(got.to_dense_numpy() != 0, reach)
    assert algos.diameter(a) == 4
    cs.same_partition(algos.connected_components(a), [0] * 5 + [1] * 2, "t")


def test_einsum_reference_saturates():
    big = np.array([[2**63, 2**63]], np.uint64)
    out = cs.einsum_reference("ab,cb->ac", [big, big], "u64")
    assert out[0, 0] == 2**64 - 1
    f = cs.einsum_reference("ab,b->a", [np.ones((2, 3), np.float32),
                                        np.arange(3, dtype=np.float32)], "f32")
    np.testing.assert_array_equal(f, [3.0, 3.0])
