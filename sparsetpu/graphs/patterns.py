"""Dense boolean-pattern engine: graph iterations as int8 matmuls.

Reachability, transitive closure, components and diameter consume only the
nnz PATTERN of each power (src/graph_csr.rs:545-575, :1228-1319) — the
values are clamped to one between steps anyway (algos._pattern).  For any
graph whose n x n int8 frame fits HBM, iterating the pattern as a dense
int8 matrix turns every squaring into ONE int8 matmul:

    next = (x @ x > 0)            # int8 x int8 -> int32 accumulate, clamp

which is exact unconditionally (row sums <= n < 2^31), needs no capacity
planning, no sorts, no expansion streams — and the whole fixed-point loop
runs as a single ``lax.while_loop`` dispatch, so the host sync is paid
once per ALGORITHM instead of once per squaring.  A 2.7k-node closure is a
7 MB frame; the sparse route reaches the same answer through
capacity-doubling ESC dispatches with a host sync each.

The sparse ESC route remains the path for n above the frame budget
(nell 65k, ogbn 169k) and for anything needing exact path COUNTS.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..csr import SparseCSR
from ..semiring import Semiring

# densest frame the pattern route may allocate: n^2 int8 bytes for 2-3
# carried frames plus the matmul's transient int32 accumulator (4 bytes) —
# n = 32768 keeps the peak under ~7 GB (a bound that awaits a re-fit for
# the H100's 80 GB, ROADMAP C4)
MAX_PATTERN_N = 32768


def fits(n: int) -> bool:
    """True when the dense pattern route may run at this node count."""
    return n <= MAX_PATTERN_N


def bucket(n: int) -> int:
    """Frame side for node count n: the next power of two (min 512).

    Every driver pads its frame to the bucket, so ONE compiled while-loop
    program serves every graph in the bucket instead of one compile per
    (algorithm, n) pair.  Pad rows/cols are structurally zero; the
    closure drivers add self-loops on them, which leaves every nnz
    comparison offset by a constant and all real entries untouched."""
    return max(512, 1 << (max(int(n), 1) - 1).bit_length())


def from_csr(a: SparseCSR, pad_to: Optional[int] = None) -> jnp.ndarray:
    """CSR -> dense int8 pattern frame (entries present -> 1).

    ``pad_to``: emit a (pad_to, pad_to) frame with the pattern in the
    top-left corner (compile-bucket padding; requires square-ish use —
    pad_to >= max(n, m))."""
    n, m = a.shape
    np_, mp_ = (pad_to, pad_to) if pad_to else (n, m)
    assert np_ >= n and mp_ >= m, (a.shape, pad_to)
    valid = jnp.arange(a.capacity) < a.nnz
    r = jnp.clip(a.row_of_slot(), 0, n - 1)
    c = jnp.clip(a.col_idx, 0, m - 1)
    flat = jnp.where(valid, r * jnp.int32(mp_) + c, np_ * mp_)
    frame = jnp.zeros((np_ * mp_,), jnp.int8).at[flat].set(
        jnp.int8(1), mode="drop")
    return frame.reshape(np_, mp_)


def to_csr(x: jnp.ndarray, sr: Semiring,
           capacity: Optional[int] = None) -> SparseCSR:
    """Pattern frame -> SparseCSR with all stored values one."""
    ones = tuple(
        jnp.where(x != 0, o, jnp.zeros((), o.dtype))
        for o in sr.ones(x.shape)
    )
    return SparseCSR.from_dense_device(ones, sr, capacity=capacity)


def matmul(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Boolean pattern product: one int8 matmul, int32 accumulation
    (exact: row sums <= n < 2^31), clamped back to {0, 1} int8."""
    acc = jax.lax.dot(x, y, preferred_element_type=jnp.int32)
    return (acc > 0).astype(jnp.int8)


def add_identity(x: jnp.ndarray) -> jnp.ndarray:
    n = x.shape[0]
    return x | jnp.eye(n, dtype=jnp.int8)


def nnz(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(x.astype(jnp.int32)).astype(jnp.int32)


@partial(jax.jit, static_argnames=("max_iters",))
def closure_while(x0: jnp.ndarray, max_iters: int = 64):
    """Squaring fixed point: returns (closure, start, k, start_len).

    ``start`` is the power two squarings behind the stable point at reach
    length ``start_len`` — stability is detected one squaring AFTER the
    closure is first reached, so the power ONE behind is already full;
    two behind is the last provably-refinable point (the diameter
    refinement's start).  One device dispatch for the whole loop."""

    def cond(carry):
        prev2, prev, cur, k, _, stable = carry
        return (~stable) & (k < max_iters)

    def body(carry):
        prev2, prev, cur, k, p2len, _ = carry
        nxt = matmul(cur, cur)
        stable = jnp.all(nxt == cur)
        # reach lengths after step i=k+1: cur=2^i, prev=2^(i-1), prev2 =
        # 2^(i-2) clamped at 1 (prev2 only starts moving at the 3rd step)
        new_p2len = jnp.where(k >= 2, p2len * 2, jnp.int32(1))
        return prev, cur, nxt, k + 1, new_p2len, stable

    prev2, prev, cur, k, p2len, _ = jax.lax.while_loop(
        cond, body,
        (x0, x0, x0, jnp.int32(0), jnp.int32(1), jnp.array(False))
    )
    return cur, prev2, k, p2len


@partial(jax.jit, static_argnames=("max_iters",))
def reachability_while(x0: jnp.ndarray, max_iters: int = 64):
    """S = A | A^2 | ... until S stabilizes; returns (S, k) with k = the
    number of powers folded in (reference reachability_sum semantics:
    k counts A once plus each added power, src/graph_csr.rs:545-558)."""

    def cond(carry):
        power, total, k, stable = carry
        return (~stable) & (k < max_iters)

    def body(carry):
        power, total, k, _ = carry
        power = matmul(power, x0)
        new_total = total | power
        stable = jnp.all(new_total == total)
        return power, new_total, k + 1, stable

    power, total, k, _ = jax.lax.while_loop(
        cond, body, (x0, x0, jnp.int32(1), jnp.array(False))
    )
    return total, k


@partial(jax.jit, static_argnames=("max_steps",))
def refine_while(reach: jnp.ndarray, base: jnp.ndarray,
                 target_nnz: jnp.ndarray, d0: jnp.ndarray,
                 max_steps: int = 4096):
    """Linear refinement: multiply by base until the pattern count hits
    ``target_nnz``; returns the step count d (the diameter)."""

    def cond(carry):
        cur, d, steps = carry
        return (nnz(cur) != target_nnz) & (steps < max_steps)

    def body(carry):
        cur, d, steps = carry
        return matmul(cur, base), d + 1, steps + 1

    _, d, _ = jax.lax.while_loop(
        cond, body, (reach, d0, jnp.int32(0)))
    return d


@partial(jax.jit, static_argnames=("max_iters", "max_steps"))
def _diameter_while(base: jnp.ndarray, max_iters: int = 64,
                    max_steps: int = 4096) -> jnp.ndarray:
    """Fused diameter program: squaring fixed point + linear refinement in
    ONE compiled dispatch (the jitted sub-loops inline).  Refinement walks
    from the last provably-non-full power; when the graph is complete
    (base itself full) start==base and d stays 1."""
    closure, start, k, start_len = closure_while(base, max_iters=max_iters)
    target = nnz(closure)
    return refine_while(start, base, target, start_len,
                        max_steps=max_steps)


def diameter(a: SparseCSR, max_iters: int = 64) -> int:
    """Diameter via dense-pattern squaring + linear refinement — the dense
    fast path of algos.diameter (identical answer, one fused dispatch,
    one compile per frame bucket)."""
    base = add_identity(from_csr(a, pad_to=bucket(a.n_rows)))
    return int(jax.device_get(_diameter_while(base, max_iters=max_iters)))


def power_until_stable(a: SparseCSR, max_iters: int = 64
                       ) -> Tuple[SparseCSR, int]:
    """Dense-pattern analog of algos.power_until_stable(pattern=True):
    same (fixed-point matrix, squaring count) with all values one.
    Pad rows are structurally zero and stay zero through squaring."""
    n, m = a.shape
    x0 = from_csr(a, pad_to=bucket(a.n_rows))
    closure, _, k, _ = closure_while(x0, max_iters=max_iters)
    k_i = int(jax.device_get(k))
    if k_i >= max_iters:
        raise RuntimeError("power_until_stable did not converge")
    closure = closure[:n, :m]
    cap = 1 << (max(int(jax.device_get(nnz(closure))), 1) - 1).bit_length()
    return to_csr(closure, a.sr, capacity=cap), k_i


def reachability_sum(a: SparseCSR, max_iters: int = 64
                     ) -> Tuple[SparseCSR, int]:
    """Dense-pattern analog of algos.reachability_sum(pattern=True)."""
    n, m = a.shape
    total, k = reachability_while(from_csr(a, pad_to=bucket(a.n_rows)),
                                  max_iters=max_iters)
    k_i = int(jax.device_get(k))
    if k_i >= max_iters:
        raise RuntimeError("reachability did not converge")
    total = total[:n, :m]
    cap = 1 << (max(int(jax.device_get(nnz(total))), 1) - 1).bit_length()
    return to_csr(total, a.sr, capacity=cap), k_i


@jax.jit
def _mutual_reps(closure: jnp.ndarray) -> jnp.ndarray:
    """Component representative per node: first j with mutual reachability
    (closure & closure^T is symmetric and reflexive, so argmax of int8
    finds each row's smallest mutually-reachable node)."""
    mutual = closure & closure.T
    return jnp.argmax(mutual, axis=1).astype(jnp.int32)


def connected_components_closure(a: SparseCSR) -> np.ndarray:
    """Components via dense transitive closure: (A|I) squared to fixed
    point, mutual reachability = same component (reference
    src/graph_csr.rs:578-600), labels sequential by first appearance.
    Pad rows carry only their self-loop; their reps are sliced away."""
    base = add_identity(from_csr(a, pad_to=bucket(a.n_rows)))
    closure, _, k, _ = closure_while(base)
    rep = np.asarray(jax.device_get(_mutual_reps(closure)))[: a.n_rows]
    _, inv = np.unique(rep, return_inverse=True)
    return inv.astype(np.int64)
