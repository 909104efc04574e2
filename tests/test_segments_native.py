"""Native-op segmented saturating scan (ops/segments.py).

The associative-scan formulation is compile-bounded; the replacement
computes segment totals from modular 16-bit plane cumsums.  This battery checks the
replacement against Python-bigint folds at the edges the plane math could
get wrong: saturation, values at limb boundaries, segment-length guard,
both axes, u32 and u64.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from sparsetpu.ops import segments
from sparsetpu.semiring import U32, U64, by_name

U64_MAX = (1 << 64) - 1
U32_MAX = (1 << 32) - 1


def _fold_ref(vals, heads, sat):
    """Python-bigint fold of saturating adds — the exact reference."""
    out = []
    acc = 0
    for v, h in zip(vals, heads):
        acc = min(int(v), sat) if h else min(acc + int(v), sat)
        out.append(acc)
    return out


def _run_1d(sr, vals_np, heads_np):
    limbs = sr.from_numpy(vals_np)
    totals, ok = segments.segment_reduce_sorted(
        sr, jnp.asarray(heads_np), limbs)
    return sr.to_numpy(totals), bool(ok)


@pytest.mark.parametrize("sr,sat", [(U64, U64_MAX), (U32, U32_MAX)])
def test_random_segments_match_bigint_fold(sr, sat):
    rng = np.random.default_rng(5)
    n = 4096
    vals = rng.integers(0, 1 << 20, n).astype(np.uint64)
    heads = rng.random(n) < 0.1
    heads[0] = True
    got, ok = _run_1d(sr, vals, heads)
    assert ok
    ref = _fold_ref(vals, heads, sat)
    assert [int(x) for x in got] == ref


def test_u64_saturation_in_merge():
    # two near-max values in one segment saturate exactly like the fold
    vals = np.array([U64_MAX - 5, 10, 3, U64_MAX, 1], np.uint64)
    heads = np.array([True, False, True, False, False])
    got, ok = _run_1d(U64, vals, heads)
    assert ok
    assert [int(x) for x in got] == _fold_ref(vals, heads, U64_MAX)


def test_u32_saturation_and_boundary_values():
    vals = np.array([0xFFFF, 0xFFFF, 0x10000, U32_MAX - 1, 1, 7],
                    np.uint64)
    heads = np.array([True, False, False, True, False, True])
    got, ok = _run_1d(U32, vals, heads)
    assert ok
    assert [int(x) for x in got] == _fold_ref(vals, heads, U32_MAX)


def test_plane_boundary_values_u64():
    # values that live entirely in one 16-bit plane each; carries must
    # ripple across all four planes
    vals = np.array([0xFFFF, 0xFFFF0000, 0xFFFF00000000,
                     0xFFFF000000000000, 1], np.uint64)
    heads = np.array([True, False, False, False, False])
    got, ok = _run_1d(U64, vals, heads)
    assert ok
    assert [int(x) for x in got] == _fold_ref(vals, heads, U64_MAX)


def test_long_segment_trips_exactness_guard():
    n = (1 << 16) + 16
    vals = np.ones(n, np.uint64)
    heads = np.zeros(n, bool)
    heads[0] = True
    _, ok = _run_1d(U64, vals, heads)
    assert not ok
    # ... and reduce_sorted_coo surfaces it as a poisoned count
    keys = [jnp.zeros((n,), jnp.int32)]
    totals_keys, _, count = segments.reduce_sorted_coo(
        U64, keys, U64.from_numpy(vals), jnp.ones((n,), bool), 8,
        key_fills=[segments.INT32_SENTINEL],
    )
    assert int(count) == -1


def test_axis1_lane_path_matches_fold():
    rng = np.random.default_rng(9)
    R, L = 8, 256
    vals = rng.integers(0, 1 << 30, (R, L)).astype(np.uint64)
    heads = rng.random((R, L)) < 0.2
    heads[:, 0] = True
    limbs = U64.from_numpy(vals)
    totals, ok = segments.segment_reduce_sorted(
        U64, jnp.asarray(heads), limbs, axis=1)
    assert bool(ok)
    got = U64.to_numpy(totals)
    for r in range(R):
        ref = _fold_ref(vals[r], heads[r], U64_MAX)
        assert [int(x) for x in got[r]] == ref
