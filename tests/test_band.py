"""Block-band dense SpGEMM tests: band split/extract round-trips and exact
agreement of the categorized (band + outlier) path with the ESC kernel."""

import numpy as np
import pytest

from sparsetpu import SparseCSR, U64, spgemm_auto
from sparsetpu.graphs import algos, generate
from sparsetpu.kernels import bandmm
from sparsetpu.ops import hybrid


def _dev(coo, capacity=None):
    rows, cols, vals, n = coo
    return SparseCSR.from_coo(rows, cols, vals, n, sr=U64, capacity=capacity)


class TestBandFormat:
    def test_split_roundtrip_linear(self):
        coo = generate.lattice([24], torus=False)  # path graph, bandwidth 1
        a = _dev(coo)
        band, out = bandmm.csr_band_split(a, half_width=1, block=8)
        assert int(out.nnz) == 0
        back = bandmm.band_to_csr(band, sr=U64)
        np.testing.assert_array_equal(back.to_dense_numpy(), a.to_dense_numpy())

    def test_split_roundtrip_cyclic(self):
        coo = generate.lattice([24], torus=True)  # ring: wrap edges
        a = _dev(coo)
        band, out = bandmm.csr_band_split(a, half_width=1, block=8, cyclic=True)
        assert int(out.nnz) == 0  # wrap edges are in the cyclic band
        back = bandmm.band_to_csr(band, sr=U64)
        np.testing.assert_array_equal(back.to_dense_numpy(), a.to_dense_numpy())

    def test_split_outliers_linear(self):
        # ring with linear band: the two wrap edges become outliers
        # (ring must be large enough that the block band cannot cover them)
        coo = generate.lattice([64], torus=True)
        a = _dev(coo)
        band, out = bandmm.csr_band_split(a, half_width=1, block=8, cyclic=False)
        assert int(out.nnz) == 2
        merged = hybrid.HybridMatrix(band, out).to_csr(sr=U64)
        np.testing.assert_array_equal(merged.to_dense_numpy(), a.to_dense_numpy())


class TestBandMatmul:
    @pytest.mark.parametrize("torus,cyclic", [(False, False), (True, True)])
    def test_matches_esc_1d(self, torus, cyclic):
        coo = generate.lattice([32], torus=torus)
        a = _dev(coo)
        want = spgemm_auto(a, a)
        band, out = bandmm.csr_band_split(a, half_width=1, block=8, cyclic=cyclic)
        assert int(out.nnz) == 0
        c = bandmm.band_matmul(band, band)
        got = bandmm.band_to_csr(c, sr=U64)
        np.testing.assert_array_equal(got.to_dense_numpy(), want.to_dense_numpy())

    def test_matches_esc_torus_3d(self):
        # small 3-D Moore torus, the headline structure; block | n
        coo = generate.lattice([4, 4, 4], torus=True)
        a = _dev(coo)
        want = spgemm_auto(a, a)
        # bandwidth of a 4x4x4 Moore torus: 16+4+1 = 21 (cyclic)
        band, out = bandmm.csr_band_split(a, half_width=21, block=8, cyclic=True)
        assert int(out.nnz) == 0
        c = bandmm.band_matmul(band, band)
        got = bandmm.band_to_csr(c, sr=U64)
        np.testing.assert_array_equal(got.to_dense_numpy(), want.to_dense_numpy())

    def test_limb_path_matches_f32(self):
        # bf16 8-bit-limb decomposition must be bit-identical to the exact
        # f32 path (values here up to ~26^2 need 2 limbs)
        coo = generate.lattice([4, 4, 4], torus=True)
        a = _dev(coo)
        band, _ = bandmm.csr_band_split(a, half_width=21, block=8, cyclic=True)
        c_f32 = bandmm.band_matmul(band, band)
        a2 = bandmm.band_to_csr(c_f32, sr=U64)
        c2_limb = bandmm.band_matmul(c_f32, c_f32, p_limbs=2, a_limbs=2)
        c2_f32 = bandmm.band_matmul(c_f32, c_f32)
        np.testing.assert_array_equal(
            np.asarray(c2_limb.data), np.asarray(c2_f32.data)
        )
        assert bandmm.limbs_for_max(255) == 1
        assert bandmm.limbs_for_max(256) == 2
        assert bandmm.limbs_for_max(70000) == 3

    def test_chain_power4(self):
        coo = generate.lattice([4, 4, 4], torus=True)
        coo = generate.thin(coo, 0.5, seed=9)
        a = _dev(coo)
        band, _ = bandmm.csr_band_split(a, half_width=21, block=8, cyclic=True)
        cur_band = band
        # numpy int64 oracle — the spgemm_auto comparator chain compiled a
        # second kernel stack per power
        ad = a.to_dense_numpy().astype(np.int64)
        want = ad
        for _ in range(2):  # up to A^3 (band growth 3*24 < half of 64 blocks)
            cur_band = bandmm.band_matmul(cur_band, band)
            want = want @ ad
            got = bandmm.band_to_csr(cur_band, sr=U64)
            np.testing.assert_array_equal(
                got.to_dense_numpy().astype(np.int64), want
            )


class TestHybrid:
    def test_hybrid_with_outliers(self):
        # random banded graph + a few far off-band entries
        rng = np.random.default_rng(4)
        n = 48
        dense = np.zeros((n, n), np.uint64)
        for r in range(n):
            for dc in (-2, -1, 1, 2):
                c = r + dc
                if 0 <= c < n and rng.random() < 0.7:
                    dense[r, c] = rng.integers(1, 4)
        dense[0, 40] = 3
        dense[45, 2] = 2
        dense[20, 44] = 1
        a = SparseCSR.from_dense_numpy(dense, sr=U64)
        want = spgemm_auto(a, a)

        h = hybrid.hybrid_from_csr(a, half_width=2, block=8, cyclic=False)
        assert int(h.outliers.nnz) == 3
        c = hybrid.hybrid_matmul(h, h, a_csr=a)
        got = c.to_csr(sr=U64)
        np.testing.assert_array_equal(got.to_dense_numpy(), want.to_dense_numpy())

    def test_rcm_then_band(self):
        # general graph: RCM to band, then categorized matmul == ESC
        coo = generate.lattice([6, 5], torus=False)
        rng = np.random.default_rng(1)
        a0 = _dev(coo)
        a = algos.permute(a0, rng.permutation(30))  # scrambled
        banded, perm = algos.rcm(a)
        bw, _ = algos.bandwidth_stats(banded)
        want = spgemm_auto(banded, banded)
        h = hybrid.hybrid_from_csr(banded, half_width=bw, block=8)
        c = hybrid.hybrid_matmul(h, h, a_csr=banded)
        got = c.to_csr(sr=U64)
        np.testing.assert_array_equal(got.to_dense_numpy(), want.to_dense_numpy())

    def test_value_limit_guard(self):
        a = SparseCSR.from_coo([0], [0], [1 << 25], 2, sr=U64)
        with pytest.raises(ValueError, match="2\\^24"):
            hybrid.hybrid_from_csr(a, half_width=1, block=2)
