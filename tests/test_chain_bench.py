"""Chain-bench driver paths (bench/chain.py): host-side build + native
oracle helpers and the dense-accumulator chain's per_step timing modes —
the code bench.py runs (reference bench_repeated_exponentiation,
src/graph_magnus.rs:700-788)."""

import math

import numpy as np
import pytest

from sparsetpu.bench.chain import (
    build_torus_host, chain_csv, native_chain_stats_host, run_chain_pallas,
    verify_final_values,
)


@pytest.fixture(scope="module")
def torus():
    h = build_torus_host(dims=(4, 4, 4))
    stats, final = native_chain_stats_host(
        h.row_ptr, h.col_idx, h.vals_u64(), h.n, 4
    )
    return h, stats, final


def test_host_build_matches_device(torus):
    h, stats, final = torus
    a = h.to_device()
    assert int(a.nnz) == h.nnz
    rp, ci, vals = a.to_numpy()
    np.testing.assert_array_equal(rp, h.row_ptr)


def test_pallas_chain_headline_only(torus):
    """per_step=False times only the A^max differential; untimed steps
    still report exact nnz."""
    h, stats, final = torus
    a = h.to_device()
    results = run_chain_pallas(a, max_step=4, iters=1, per_step=False,
                               verbose=False)
    assert [r.step for r in results] == [2, 3, 4]
    for rec, (step, want_nnz, *_) in zip(results, stats):
        assert rec.step == step and rec.nnz == want_nnz
    assert math.isnan(results[0].seconds)
    assert math.isnan(results[1].seconds)
    assert results[-1].seconds > 0 and math.isfinite(results[-1].seconds)
    csv = chain_csv(results)
    assert csv.count("\n") == 2  # header + the one timed row
    verify_final_values(a, final, max_step=4, sample_rows=32)


def test_pallas_chain_per_step(torus):
    h, stats, final = torus
    a = h.to_device()
    results = run_chain_pallas(a, max_step=4, iters=1, per_step=True,
                               verbose=False)
    assert all(math.isfinite(r.seconds) and r.seconds > 0 for r in results)
    for rec, (step, want_nnz, *_) in zip(results, stats):
        assert rec.step == step and rec.nnz == want_nnz
