"""Every f32 matmul site asks for full f32 products (Precision.HIGHEST),
read from the jaxpr: a GPU may otherwise run an f32 matmul in TF32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparsetpu import SparseCSR
from sparsetpu.graphs.generate import random_graph


def _dots(jaxpr):
    """Every dot_general equation, descending into sub-jaxprs."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (tuple, list)) else (p,)):
                inner = getattr(sub, "jaxpr", None)
                if inner is not None:
                    yield from _dots(getattr(inner, "jaxpr", inner))


def _f32_dot_precisions(fn, *args):
    closed = jax.make_jaxpr(fn)(*args)
    out = []
    for eqn in _dots(closed.jaxpr):
        if all(v.aval.dtype == jnp.float32 for v in eqn.invars):
            out.append(eqn.params["precision"])
    return out


def _attention():
    from sparsetpu.attention import scores

    x = jnp.ones((2, 3, 4, 8), jnp.float32)
    return scores.attention_scores_dense, (x, x)


def _engine_dense():
    from sparsetpu.einsum import engine

    x = jnp.ones((4, 4), jnp.float32)
    return (lambda a, b: engine._dense_exec("ab,bc->ac", a, b)), (x, x)


def _blocksparse():
    from sparsetpu.kernels import blocksparse

    q = jnp.ones((256, 16), jnp.float32)
    idx = jnp.array([0, 1], jnp.int32)
    return blocksparse.sdd_block_scores, (q, q, idx, idx)


def _densedense():
    from sparsetpu.ops import denseacc

    a = SparseCSR.from_coo_host(*random_graph(32, 64, seed=1))
    return (lambda x: denseacc.densedense_numeric(x, x, 1024)), (a,)


def _densedense_tiled_panel():
    from sparsetpu.ops import denseacc

    a = SparseCSR.from_coo_host(*random_graph(32, 64, seed=2))
    ad = jnp.ones((32, 32), jnp.float32)
    return (lambda x, b: denseacc._mm_panel_dense(x, b, 0, 32)), (ad, a)


@pytest.mark.parametrize("site", [_attention, _engine_dense, _blocksparse,
                                  _densedense, _densedense_tiled_panel])
def test_f32_matmul_is_highest(site):
    fn, args = site()
    precisions = _f32_dot_precisions(fn, *args)
    assert precisions, "no f32 matmul found at this site"
    highest = jax.lax.Precision.HIGHEST
    for p in precisions:
        assert p == (highest, highest), p


def test_attention_scores_match_float64():
    from sparsetpu.attention import scores

    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 8, 4, 64)).astype(np.float32)
    k = rng.standard_normal((2, 8, 4, 64)).astype(np.float32)
    got = np.asarray(scores.attention_scores_dense_jit(q, k))
    want = np.einsum("bshd,bsgd->bshg", q.astype(np.float64),
                     k.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
