"""Einsum engine tests: parser validation + differential sweep vs np.einsum.

The reference's signature test is an exhaustive spec sweep checked bit-exact
against a naive oracle (linalg/tests/einsum_sweep.rs, ~19.5M cases).  Here a
bounded sweep runs in CI (spec alphabet {a,b,c}, 1-2 inputs, rank <= 3, dims
{2,3}, dense x sparse masks, small-int f32 values => bit-exact); the full
sweep scales via the `long` marker.
"""

import itertools

import numpy as np
import pytest

from sparsetpu import SparseCSR, U64, F32SR
from sparsetpu.einsum.engine import einsum
from sparsetpu.einsum.parser import InvalidSpec, parse_spec
from sparsetpu.utils import oracle


class TestParser:
    def test_basic(self):
        s = parse_spec("ab,bc->ac")
        assert s.inputs == (("a", "b"), ("b", "c"))
        assert s.outputs == (("a", "c"),)
        assert s.contracted == ["b"]

    def test_multi_output(self):
        s = parse_spec("ab,bc->ac,ca")
        assert len(s.outputs) == 2

    def test_scalar_output(self):
        s = parse_spec("ab->")
        assert s.outputs == ((),)

    @pytest.mark.parametrize(
        "spec,kind",
        [
            ("", "Empty"),
            ("ab,bc", "NoArrow"),
            ("ab->a->b", "MultipleArrows"),
            ("->a", "NoInputs"),
            ("ab,,bc->ac", "EmptyInput"),
            ("aB->a", "BadChar"),
            ("ab->aa", "RepeatedOutputIndex"),
            ("ab->ac", "OutputIndexNotInInput"),
        ],
    )
    def test_invalid(self, spec, kind):
        with pytest.raises(InvalidSpec) as e:
            parse_spec(spec)
        assert e.value.kind == kind

    def test_dim_mismatch(self):
        with pytest.raises(InvalidSpec) as e:
            einsum("ab,bc->ac", [np.ones((2, 3), np.float32),
                                 np.ones((4, 2), np.float32)])
        assert e.value.kind == "DimMismatch"


def _rand_dense(shape, seed):
    rng = np.random.default_rng(seed)
    # small ints in f32 => all engines bit-exact (reference sweep trick)
    return (rng.integers(0, 4, size=shape) * (rng.random(shape) < 0.6)).astype(
        np.float32
    )


class TestEngineF32:
    def test_matmul_dense(self):
        a, b = _rand_dense((4, 5), 0), _rand_dense((5, 3), 1)
        (got,) = einsum("ab,bc->ac", [a, b])
        np.testing.assert_array_equal(np.asarray(got), a @ b)

    def test_matmul_sparse_sparse(self):
        a, b = _rand_dense((6, 6), 2), _rand_dense((6, 6), 3)
        sa = SparseCSR.from_dense_numpy(a, sr=F32SR)
        sb = SparseCSR.from_dense_numpy(b, sr=F32SR)
        (got,) = einsum("ij,jk->ik", [sa, sb])
        np.testing.assert_array_equal(np.asarray(got), a @ b)

    def test_matmul_sparse_transposed_pattern(self):
        a, b = _rand_dense((4, 6), 4), _rand_dense((5, 6), 5)
        sa = SparseCSR.from_dense_numpy(a, sr=F32SR)
        sb = SparseCSR.from_dense_numpy(b, sr=F32SR)
        (got,) = einsum("ab,cb->ac", [sa, sb])
        np.testing.assert_array_equal(np.asarray(got), a @ b.T)

    def test_multi_output(self):
        a, b = _rand_dense((3, 3), 6), _rand_dense((3, 3), 7)
        got = einsum("ab,bc->ac,ca", [a, b])
        np.testing.assert_array_equal(np.asarray(got[0]), a @ b)
        np.testing.assert_array_equal(np.asarray(got[1]), (a @ b).T)

    def test_trace_diagonal(self):
        a = _rand_dense((4, 4), 8)
        (got,) = einsum("aa->a", [a])
        np.testing.assert_array_equal(np.asarray(got), np.diag(a))
        (tr,) = einsum("aa->", [a])
        np.testing.assert_array_equal(np.asarray(tr), np.trace(a))

    def test_scalar_and_outer(self):
        a, b = _rand_dense((3,), 9), _rand_dense((4,), 10)
        (got,) = einsum("a,b->ab", [a, b])
        np.testing.assert_array_equal(np.asarray(got), np.outer(a, b))


class TestEngineU64:
    def test_matmul_saturating(self):
        big = (1 << 62) + 5
        da = np.array([[big, 0], [1, 2]], np.uint64)
        db = np.array([[7, 0], [0, 3]], np.uint64)
        sa = SparseCSR.from_dense_numpy(da, sr=U64)
        sb = SparseCSR.from_dense_numpy(db, sr=U64)
        (got,) = einsum("ab,bc->ac", [sa, sb], sr=U64)
        want = oracle.to_dense(
            oracle.matmul(
                {(0, 0): big, (1, 0): 1, (1, 1): 2},
                {(0, 0): 7, (1, 1): 3},
            ),
            2,
        )
        np.testing.assert_array_equal(U64.to_numpy(got), want)

    def test_fallback_dense_u64(self):
        da = np.array([[1, 2], [3, 4]], np.uint64)
        a = U64.from_numpy(da)
        (got,) = einsum("ab->b", [a], sr=U64)
        np.testing.assert_array_equal(U64.to_numpy(got), da.sum(axis=0))


def _sweep_cases():
    """Bounded version of the reference differential sweep."""
    specs = []
    # 1-input specs over {a, b}
    for inp in ["a", "ab", "aa", "ba", "abc", "aba"]:
        letters = sorted(set(inp))
        for r in range(len(letters) + 1):
            for out in itertools.permutations(letters, r):
                specs.append((inp, "".join(out)))
    # 2-input specs
    for i1, i2 in [("ab", "bc"), ("ab", "cb"), ("ab", "ab"), ("a", "ab"),
                   ("ab", "b"), ("abc", "cb"), ("ab", "ba")]:
        letters = sorted(set(i1) | set(i2))
        for r in range(min(len(letters), 2) + 1):
            for out in itertools.permutations(letters, r):
                specs.append((f"{i1},{i2}", "".join(out)))
    return specs


@pytest.mark.parametrize("lhs,out", _sweep_cases())
def test_differential_sweep(lhs, out):
    spec = f"{lhs}->{out}"
    dims = {ch: 2 + (ord(ch) % 2) for ch in set(lhs) - {","}}
    inputs = lhs.split(",")
    ops_np = []
    for idx, inp in enumerate(inputs):
        shape = tuple(dims[ch] for ch in inp)
        ops_np.append(_rand_dense(shape, seed=idx * 31 + len(spec)))
    want = np.einsum(spec, *ops_np)

    # dense operands
    (got,) = einsum(spec, ops_np)
    np.testing.assert_array_equal(np.asarray(got), want.astype(np.float32))

    # sparse 2-D operands where possible (distinct letters only)
    ops_sp = [
        SparseCSR.from_dense_numpy(o, sr=F32SR)
        if o.ndim == 2 and len(set(inp)) == 2
        else o
        for o, inp in zip(ops_np, inputs)
    ]
    if any(isinstance(o, SparseCSR) for o in ops_sp):
        (got_sp,) = einsum(spec, ops_sp)
        np.testing.assert_array_equal(np.asarray(got_sp), want.astype(np.float32))


def _long_sweep_cases():
    """Extended differential sweep (reference einsum_sweep.rs scale-down):
    alphabet {a,b,c,d}, 1-2 inputs up to rank 3 with repeats, all output
    permutations, dims {2,3,4,5} keyed by letter."""
    inputs1 = ["a", "ab", "aa", "abc", "aab", "aba", "baa", "abcd"]
    inputs2 = [("ab", "bc"), ("ab", "cb"), ("ba", "bc"), ("ab", "ab"),
               ("ab", "ba"), ("abc", "cd"), ("abc", "bc"), ("abc", "acd"),
               ("aab", "bc"), ("ab", "bb"), ("a", "a"), ("abc", "abc")]
    cases = []
    for inp in inputs1:
        letters = sorted(set(inp))
        for r in range(len(letters) + 1):
            for out in itertools.permutations(letters, r):
                cases.append((inp, "".join(out)))
    for i1, i2 in inputs2:
        letters = sorted(set(i1) | set(i2))
        for r in range(min(len(letters), 3) + 1):
            for out in itertools.permutations(letters, r):
                cases.append((f"{i1},{i2}", "".join(out)))
    return cases


@pytest.mark.long
def test_differential_sweep_long():
    dims_of = {"a": 2, "b": 3, "c": 4, "d": 5}
    n_checked = 0
    for lhs, out in _long_sweep_cases():
        spec = f"{lhs}->{out}"
        inputs = lhs.split(",")
        ops_np = []
        for idx, inp in enumerate(inputs):
            shape = tuple(dims_of[ch] for ch in inp)
            ops_np.append(_rand_dense(shape, seed=idx * 131 + len(spec) * 7))
        want = np.einsum(spec, *ops_np).astype(np.float32)
        (got,) = einsum(spec, ops_np)
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=spec)
        # sparse variants for 2-D distinct-letter operands
        ops_sp = [
            SparseCSR.from_dense_numpy(o, sr=F32SR)
            if o.ndim == 2 and len(set(inp)) == 2 else o
            for o, inp in zip(ops_np, inputs)
        ]
        if any(isinstance(o, SparseCSR) for o in ops_sp):
            (got_sp,) = einsum(spec, ops_sp)
            np.testing.assert_array_equal(np.asarray(got_sp), want, err_msg=spec)
        n_checked += 1
    print(f"\nlong einsum sweep: {n_checked} specs checked bit-exact")


class TestSpMMLowering:
    """Sparse x dense matmul/matvec specs lower to the SpMM gather kernel
    (ops/spmm.py) with no host round-trip of the dense operand (reference
    VM CSR x Dense schedule, linalg/src/einsum.rs:591-626)."""

    def _pair(self, n, k, m, seed):
        a = _rand_dense((n, k), seed)
        b = _rand_dense((k, m), seed + 1)
        return a, b

    def test_sparse_dense_matmul(self):
        a, b = self._pair(6, 7, 5, 20)
        sa = SparseCSR.from_dense_numpy(a, sr=F32SR)
        (got,) = einsum("ab,bc->ac", [sa, b])
        np.testing.assert_array_equal(np.asarray(got), a @ b)

    def test_dense_sparse_matmul(self):
        a, b = self._pair(6, 7, 5, 22)
        sb = SparseCSR.from_dense_numpy(b, sr=F32SR)
        (got,) = einsum("ab,bc->ac", [a, sb])
        np.testing.assert_array_equal(np.asarray(got), a @ b)

    def test_sparse_transposed(self):
        a = _rand_dense((7, 6), 24)  # contract along sparse rows
        b = _rand_dense((7, 5), 25)
        sa = SparseCSR.from_dense_numpy(a, sr=F32SR)
        (got,) = einsum("ba,bc->ac", [sa, b])
        np.testing.assert_array_equal(np.asarray(got), a.T @ b)

    def test_dense_transposed_and_reversed_output(self):
        a, b = _rand_dense((6, 7), 26), _rand_dense((5, 7), 27)
        sa = SparseCSR.from_dense_numpy(a, sr=F32SR)
        (got,) = einsum("ab,cb->ca", [sa, b])
        np.testing.assert_array_equal(np.asarray(got), (a @ b.T).T)

    def test_spmv(self):
        a = _rand_dense((6, 7), 28)
        v = _rand_dense((7,), 29)
        sa = SparseCSR.from_dense_numpy(a, sr=F32SR)
        (got,) = einsum("ab,b->a", [sa, v])
        np.testing.assert_array_equal(np.asarray(got), a @ v)
        (got2,) = einsum("b,ab->a", [v, sa])
        np.testing.assert_array_equal(np.asarray(got2), a @ v)
        (got3,) = einsum("a,ab->b", [_rand_dense((6,), 30), sa])
        np.testing.assert_array_equal(
            np.asarray(got3), _rand_dense((6,), 30) @ a
        )

    def test_sparse_output_format(self):
        a, b = self._pair(6, 7, 5, 31)
        sa = SparseCSR.from_dense_numpy(a, sr=F32SR)
        (got,) = einsum("ab,bc->ac", [sa, b], out_format="sparse")
        assert isinstance(got, SparseCSR)
        np.testing.assert_array_equal(got.to_dense_numpy(), a @ b)

    def test_routing_hits_spmm_kernel(self, monkeypatch):
        import sparsetpu.ops.spmm as spmm_mod

        calls = []
        real = spmm_mod.spmm_csr_dense
        monkeypatch.setattr(
            spmm_mod, "spmm_csr_dense",
            lambda s, d: (calls.append(1), real(s, d))[1],
        )
        a, b = self._pair(4, 5, 3, 33)
        sa = SparseCSR.from_dense_numpy(a, sr=F32SR)
        (got,) = einsum("ab,bc->ac", [sa, b])
        assert calls, "sparse x dense matmul must route through the SpMM kernel"
        np.testing.assert_array_equal(np.asarray(got), a @ b)


class TestFromDenseDevice:
    def test_matches_from_dense_numpy(self):
        d = _rand_dense((7, 5), 40)
        import jax.numpy as jnp

        got = SparseCSR.from_dense_device((jnp.asarray(d),), F32SR)
        want = SparseCSR.from_dense_numpy(d, sr=F32SR)
        np.testing.assert_array_equal(got.to_dense_numpy(), want.to_dense_numpy())
        assert int(got.nnz) == int(want.nnz)
        rp_g, ci_g, v_g = got.to_numpy()
        rp_w, ci_w, v_w = want.to_numpy()
        np.testing.assert_array_equal(rp_g, rp_w)
        np.testing.assert_array_equal(ci_g, ci_w)
        np.testing.assert_array_equal(v_g, v_w)

    def test_u64_limbs(self):
        d = np.zeros((4, 4), np.uint64)
        d[1, 2] = (1 << 40) + 3
        d[3, 0] = 7
        from sparsetpu.semiring import U64 as _U64

        got = SparseCSR.from_dense_device(_U64.from_numpy(d), _U64)
        np.testing.assert_array_equal(got.to_dense_numpy(), d)

    def test_empty(self):
        import jax.numpy as jnp

        got = SparseCSR.from_dense_device(
            (jnp.zeros((3, 3), jnp.float32),), F32SR
        )
        assert int(got.nnz) == 0


class TestChainPlanner:
    """>= 3-operand matmul chains lower through pairwise SpGEMM with sparse
    intermediates (never densified through the loop-nest fallback;
    reference scheduler: linalg/src/einsum.rs:327-389)."""

    def _rand_csr(self, n, m, nnz, seed):
        rng = np.random.default_rng(seed)
        r = rng.integers(0, n, nnz)
        c = rng.integers(0, m, nnz)
        v = rng.integers(1, 5, nnz).astype(np.uint64)
        return SparseCSR.from_coo(r, c, v, n, m, sr=U64)

    def test_three_operand_chain(self):
        a = self._rand_csr(6, 7, 12, 0)
        b = self._rand_csr(7, 5, 10, 1)
        c = self._rand_csr(5, 4, 9, 2)
        (got,) = einsum("ab,bc,cd->ad", [a, b, c], sr=U64)
        want = (a.to_dense_numpy().astype(object)
                @ b.to_dense_numpy().astype(object)
                @ c.to_dense_numpy().astype(object))
        np.testing.assert_array_equal(
            np.asarray(got[0]).astype(object)
            + (np.asarray(got[1]).astype(object) << 32),
            want,
        )

    def test_four_operand_chain_out_of_order(self):
        mats = [self._rand_csr(5, 5, 8, s) for s in range(4)]
        # shuffled operand order; planner must find the contraction chain
        (got,) = einsum("cd,ab,de,bc->ae",
                        [mats[2], mats[0], mats[3], mats[1]], sr=U64)
        want = mats[0].to_dense_numpy().astype(object)
        for m in mats[1:]:
            want = want @ m.to_dense_numpy().astype(object)
        np.testing.assert_array_equal(
            np.asarray(got[0]).astype(object)
            + (np.asarray(got[1]).astype(object) << 32),
            want,
        )

    def test_chain_transposed_output(self):
        a = self._rand_csr(4, 6, 8, 5)
        b = self._rand_csr(6, 3, 7, 6)
        (got,) = einsum("ab,bc->ca", [a, b], sr=U64)
        want = (a.to_dense_numpy() @ b.to_dense_numpy()).T
        np.testing.assert_array_equal(
            np.asarray(got[0]) + (np.asarray(got[1]).astype(np.uint64) << 32),
            want,
        )

    def test_sparse_output_format(self):
        a = self._rand_csr(6, 7, 10, 7)
        b = self._rand_csr(7, 5, 10, 8)
        (got,) = einsum("ab,bc->ac", [a, b], sr=U64, out_format="sparse")
        assert isinstance(got, SparseCSR)
        want = a.to_dense_numpy() @ b.to_dense_numpy()
        np.testing.assert_array_equal(got.to_dense_numpy(), want)

    def test_sparse_output_from_dense_path(self):
        rng = np.random.default_rng(9)
        x = rng.standard_normal((4, 5)).astype(np.float32)
        y = rng.standard_normal((5, 3)).astype(np.float32)
        (got,) = einsum("ab,bc->ac", [x, y], sr=F32SR, out_format="sparse")
        assert isinstance(got, SparseCSR)
        np.testing.assert_allclose(got.to_dense_numpy(), x @ y, rtol=1e-6)

    def test_chain_matches_fallback(self):
        # specs the planner cannot take (shared letter in 3 operands) still
        # work through the fallback — and must agree with np.einsum
        rng = np.random.default_rng(11)
        x = rng.integers(0, 3, (3, 4)).astype(np.float32)
        y = rng.integers(0, 3, (4, 3)).astype(np.float32)
        z = rng.integers(0, 3, (4, 2)).astype(np.float32)
        (got,) = einsum("ab,ba,bc->ac", [x, y, z], sr=F32SR)
        want = np.einsum("ab,ba,bc->ac", x, y, z)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6)


class TestEntryDriven:
    """Tier-2 entry-driven lowering: one sparse operand, arbitrary spec
    (traces, reductions, masks, N-D dense partners, free-letter products);
    differential vs np.einsum on small-int f32 (bit-exact)."""

    def _sp(self, shape, seed, density=0.4):
        rng = np.random.default_rng(seed)
        d = rng.integers(0, 4, size=shape).astype(np.float32)
        d *= rng.random(shape) < density
        return d, SparseCSR.from_dense_numpy(d, sr=F32SR)

    @pytest.mark.parametrize(
        "spec,dense_shapes",
        [
            ("ab->a", []),                 # row sums
            ("ab->b", []),                 # col sums
            ("ab->", []),                  # full reduction
            ("aa->", []),                  # sparse trace
            ("aa->a", []),                 # sparse diagonal
            ("ab,ab->ab", [(5, 6)]),       # elementwise mask
            ("ab,ab->a", [(5, 6)]),        # masked row reduce
            ("ab,bcd->acd", [(6, 3, 4)]),  # 3-D dense partner
            ("ab,ac->abc", [(5, 4)]),      # free-letter outer product
            ("ab,acd->bcd", [(5, 3, 4)]),  # bind row, free dense letters
            ("ab,cb,cd->ad", [(7, 6), (7, 4)]),  # sparse + 2 dense
            ("ab,b,a->", [(6,), (5,)]),    # bilinear form to scalar
        ],
    )
    def test_vs_numpy(self, spec, dense_shapes):
        n_letters = {"a": 5, "b": 6, "c": 7, "d": 4}
        ins = parse_spec(spec).inputs
        sp_shape = tuple(n_letters[ch] for ch in ins[0])
        if ins[0][0] == ins[0][1] if len(ins[0]) == 2 else False:
            sp_shape = (n_letters[ins[0][0]],) * 2
        dnp, s = self._sp(sp_shape, seed=hash(spec) % 1000)
        rng = np.random.default_rng(1 + hash(spec) % 1000)
        dense = [rng.integers(0, 4, size=sh).astype(np.float32)
                 for sh in dense_shapes]
        got = einsum(spec, [s, *dense])[0]
        want = np.einsum(spec, dnp, *dense)
        assert np.array_equal(np.asarray(got), want), spec

    def test_sparse_in_second_position(self):
        dnp, s = self._sp((5, 6), seed=9)
        d = np.arange(30, dtype=np.float32).reshape(5, 6) % 3
        got = einsum("ab,ab->b", [d, s])[0]
        assert np.array_equal(np.asarray(got), np.einsum("ab,ab->b", d, dnp))

    @pytest.mark.parametrize(
        "spec",
        [
            "ab,ab->ab",   # sparse-sparse elementwise mask
            "ab,ab->",     # sparse-sparse dot
            "ab,ba->",     # trace of product, both sparse
            "ab,ab->a",    # masked row reduce, both sparse
            "ab,ba,b->a",  # two sparse + a dense vector
        ],
    )
    def test_two_sparse_operands(self, spec):
        dims = {"a": 5, "b": 6}
        ins = parse_spec(spec).inputs
        d0, s0 = self._sp(tuple(dims[ch] for ch in ins[0]), seed=21)
        d1, s1 = self._sp(tuple(dims[ch] for ch in ins[1]), seed=22)
        dense = [
            np.arange(np.prod([dims[ch] for ch in ix]),
                      dtype=np.float32).reshape(
                          [dims[ch] for ch in ix]) % 3
            for ix in ins[2:]
        ]
        got = einsum(spec, [s0, s1, *dense])[0]
        want = np.einsum(spec, d0, d1, *dense)
        assert np.array_equal(np.asarray(got), want), spec

    @pytest.mark.parametrize(
        "spec",
        [
            "bij->bi",       # batched row sums
            "bij->b",        # per-batch reduction
            "bij,jk->bik",   # batched SpMM against a shared dense rhs
            "bij,bj->bi",    # batched SpMV
            "bij,bij->b",    # two grouped: per-batch dot
            "bij,ij->bij",   # grouped masked by a 2-D sparse
        ],
    )
    def test_grouped_driver(self, spec):
        from sparsetpu.grouped import GroupedCSR

        dims = {"b": 3, "i": 5, "j": 6, "k": 4}
        rng = np.random.default_rng(41)
        ins = parse_spec(spec).inputs
        d0 = (rng.integers(0, 4, (3, 5, 6))
              * (rng.random((3, 5, 6)) < 0.4)).astype(np.float32)
        g0 = GroupedCSR.from_dense(d0, sr=F32SR)
        args = [g0]
        nps = [d0]
        for ix in ins[1:]:
            sh = tuple(dims[ch] for ch in ix)
            if ix == ("b", "i", "j"):
                d1 = (rng.integers(0, 4, sh)
                      * (rng.random(sh) < 0.4)).astype(np.float32)
                args.append(GroupedCSR.from_dense(d1, sr=F32SR))
                nps.append(d1)
            elif ix == ("i", "j"):
                d1, s1 = self._sp(sh, seed=55)
                args.append(s1)
                nps.append(d1)
            else:
                d1 = rng.integers(0, 4, sh).astype(np.float32)
                args.append(d1)
                nps.append(d1)
        got = einsum(spec, args)[0]
        want = np.einsum(spec, *nps)
        assert np.array_equal(np.asarray(got), want), spec

    def test_lookup_primitive(self):
        d, s = self._sp((7, 9), seed=30)
        rows = np.array([0, 3, 6, 2, 8, -1], np.int32)
        cols = np.array([0, 5, 8, 100, 0, 2], np.int32)
        (got,) = s.lookup(rows, cols)
        want = [d[r, c] if 0 <= r < 7 and 0 <= c < 9 else 0.0
                for r, c in zip(rows, cols)]
        assert np.array_equal(np.asarray(got), np.float32(want))

    def test_engine_routes_entry_driven(self, monkeypatch):
        """The specs above must NOT go through the densifying fallback."""
        from sparsetpu.einsum import engine as eng

        def boom(*a, **k):
            raise AssertionError("fallback taken")

        monkeypatch.setattr(eng, "_fallback_loop_nest", boom)
        dnp, s = self._sp((5, 5), seed=3)
        got = einsum("aa->", [s])[0]
        assert np.array_equal(np.asarray(got), np.einsum("aa->", dnp))


class TestMultiOutputSinglePass:
    """Reference VM computes "ab,bc->ac,ca" outputs in one walk
    (linalg/src/einsum.rs:719-727); the engine must dispatch ONE
    contraction and derive permuted siblings by transpose."""

    def test_one_spgemm_for_permuted_outputs(self, monkeypatch):
        import sparsetpu.ops.spgemm as spg_mod

        calls = []
        real = spg_mod.spgemm_auto

        def counting(a, b, *args, **kw):
            calls.append(1)
            return real(a, b, *args, **kw)

        monkeypatch.setattr(spg_mod, "spgemm_auto", counting)
        a = np.arange(16, dtype=np.float32).reshape(4, 4) % 5
        b = (np.arange(16, dtype=np.float32).reshape(4, 4) * 3) % 7
        sa = SparseCSR.from_dense_numpy(a, sr=F32SR)
        sb = SparseCSR.from_dense_numpy(b, sr=F32SR)
        got = einsum("ab,bc->ac,ca", [sa, sb])
        assert len(calls) == 1, f"expected one SpGEMM dispatch, got {calls}"
        np.testing.assert_array_equal(np.asarray(got[0]), a @ b)
        np.testing.assert_array_equal(np.asarray(got[1]), (a @ b).T)

    def test_identical_outputs_reused(self):
        a = np.arange(12, dtype=np.float32).reshape(3, 4)
        got = einsum("ab->ba,ba", [a])
        np.testing.assert_array_equal(np.asarray(got[0]), a.T)
        np.testing.assert_array_equal(np.asarray(got[1]), a.T)

    def test_permuted_3d_outputs(self):
        a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
        got = einsum("abc->abc,cab,bca", [a])
        np.testing.assert_array_equal(np.asarray(got[0]), a)
        np.testing.assert_array_equal(
            np.asarray(got[1]), np.transpose(a, (2, 0, 1)))
        np.testing.assert_array_equal(
            np.asarray(got[2]), np.transpose(a, (1, 2, 0)))

    def test_sparse_output_format_permuted(self):
        a = np.array([[0, 2], [3, 0]], np.float32)
        b = np.array([[1, 0], [0, 4]], np.float32)
        sa = SparseCSR.from_dense_numpy(a, sr=F32SR)
        sb = SparseCSR.from_dense_numpy(b, sr=F32SR)
        got = einsum("ab,bc->ac,ca", [sa, sb], out_format="sparse")
        np.testing.assert_array_equal(got[0].to_dense_numpy(), a @ b)
        np.testing.assert_array_equal(got[1].to_dense_numpy(), (a @ b).T)


class TestU64KernelTiers:
    """Integer semirings through the SpMM / entry-driven kernel tiers
    (reference VM handles integer semirings uniformly,
    linalg/src/einsum.rs:38-85) — previously these specs densified through
    the loop-nest fallback."""

    def _su64(self, dense):
        return SparseCSR.from_dense_numpy(dense.astype(np.uint64), sr=U64)

    def test_spmm_u64_exact_and_saturating(self, monkeypatch):
        import sparsetpu.ops.spmm as spmm_mod

        calls = []
        real = spmm_mod.spmm_csr_dense_exact

        def counting(s, d):
            calls.append(1)
            return real(s, d)

        monkeypatch.setattr(spmm_mod, "spmm_csr_dense_exact", counting)
        da = np.array([[1 << 40, 0, 3], [0, 5, 0]], np.uint64)
        db = np.array([[1 << 30, 2], [3, 4], [5, 6]], np.uint64)
        sa = self._su64(da)
        (got,) = einsum("ab,bc->ac", [sa, U64.from_numpy(db)], sr=U64)
        assert calls, "u64 sparse x dense must route through the exact SpMM"
        want = np.minimum(
            da.astype(object) @ db.astype(object), 2**64 - 1
        )
        np.testing.assert_array_equal(U64.to_numpy(got).astype(object), want)

    def test_spmm_u64_transposed_variants(self):
        da = np.array([[7, 0], [0, 9], [1, 1]], np.uint64)   # (3, 2)
        dd = np.array([[2, 0, 1], [3, 4, 0], [5, 6, 7]], np.uint64)  # (3, 3)
        sa = self._su64(da)
        # ba,bc->ac: contraction along the sparse operand's rows
        (got,) = einsum("ba,bc->ac", [sa, U64.from_numpy(dd)], sr=U64)
        want = da.astype(object).T @ dd.astype(object)
        np.testing.assert_array_equal(U64.to_numpy(got).astype(object), want)
        # ab,cb->ca: dense transposed + reversed output
        (got2,) = einsum("ab,cb->ca", [self._su64(da.T),
                                       U64.from_numpy(dd)], sr=U64)
        want2 = (da.astype(object).T @ dd.astype(object).T).T
        np.testing.assert_array_equal(U64.to_numpy(got2).astype(object),
                                      want2)

    def test_spmv_u64(self):
        da = np.array([[1 << 33, 2], [0, 3]], np.uint64)
        v = np.array([4, 5], np.uint64)
        (got,) = einsum("ab,b->a", [self._su64(da), U64.from_numpy(v)],
                        sr=U64)
        want = da.astype(object) @ v.astype(object)
        np.testing.assert_array_equal(U64.to_numpy(got).astype(object), want)

    def test_entry_driven_u64_mask_product(self):
        da = np.array([[1 << 35, 0], [2, 3]], np.uint64)
        db = np.array([[1 << 35, 7], [0, 4]], np.uint64)
        sa, sb = self._su64(da), self._su64(db)
        (got,) = einsum("ab,ab->", [sa, sb], sr=U64)
        true = sum(int(x) * int(y)
                   for x, y in zip(da.ravel(), db.ravel()))
        got_i = int(U64.to_numpy(got))
        assert got_i == min(true, 2**64 - 1)

    def test_entry_driven_u64_row_reduce_and_trace(self):
        da = np.array([[1 << 40, 2, 0], [5, 0, 7], [0, 0, 9]], np.uint64)
        sa = self._su64(da)
        (got,) = einsum("ab->a", [sa], sr=U64)
        np.testing.assert_array_equal(
            U64.to_numpy(got).astype(object),
            da.astype(object).sum(axis=1))
        (tr,) = einsum("aa->", [sa], sr=U64)
        assert int(U64.to_numpy(tr)) == int(da.trace())

    def test_entry_driven_u64_saturates(self):
        big = 1 << 63
        da = np.array([[big, big], [big, 1]], np.uint64)
        sa = self._su64(da)
        (got,) = einsum("ab->", [sa], sr=U64)
        assert int(U64.to_numpy(got)) == 2**64 - 1
