"""Graph algorithms built on repeated sparse matmul, as in the reference:
reachability (src/graph_csr.rs:545-558), power-until-stable (:561-575),
connected components via closure (:578-600) and union-find (:605-651),
bandwidth stats (:806-818) and diameter via squaring (:1228-1319).

Drivers are host-side loops around jitted device kernels with
power-of-two capacity growth (XLA static shapes); the per-step compute is
entirely on device.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..csr import SparseCSR
from ..ops.elementwise import patterns_equal
from ..ops.spgemm import spadd, spgemm, spgemm_auto, symbolic_flops


def _pow2(x: int) -> int:
    return 1 << (max(x, 1) - 1).bit_length()


def _pattern(c: SparseCSR) -> SparseCSR:
    """Clamp stored values to one — the boolean-reachability view.

    Path COUNTS explode past every exact range on dense closures (a 2.7k
    power-law closure squared exceeds 2^24 per entry, killing the dense-
    accumulator's f32 carrier), but the reference's reachability/diameter
    drivers only consume the PATTERN (nnz stability,
    src/graph_csr.rs:545-575, :1228-1319) — so pattern-mode iteration
    keeps values at one between steps."""
    import dataclasses

    valid = jnp.arange(c.capacity) < c.nnz
    ones = c.sr.ones((c.capacity,))
    vals = tuple(jnp.where(valid, o, jnp.zeros((), o.dtype)) for o in ones)
    return dataclasses.replace(c, values=vals)


def matmul(a: SparseCSR, b: SparseCSR) -> SparseCSR:
    return spgemm_auto(a, b)


def add(a: SparseCSR, b: SparseCSR) -> SparseCSR:
    out = spadd(a, b, out_cap=_pow2(a.capacity + b.capacity))
    return out


def reachability_sum(a: SparseCSR, max_iters: int = 64,
                     pattern: bool = False,
                     dense: str = "auto") -> Tuple[SparseCSR, int]:
    """S = A + A^2 + ... until the nnz pattern stabilizes; returns (S, k).

    ``pattern=True`` clamps each power's values to one (see
    :func:`_pattern`) — same nnz trajectory, but values stay in the
    dense-accumulator's exact range on dense closures; S's values then
    count reachable path LENGTHS classes rather than path multiplicity.

    Pattern mode routes through the dense int8 matmul engine
    (graphs/patterns.py) when the n x n frame fits (``dense="auto"``;
    "never" forces the sparse route, "always" asserts the frame fits)."""
    if pattern and _route_dense(a.n_rows, dense):
        from . import patterns

        return patterns.reachability_sum(a, max_iters=max_iters)
    power = a
    total = a
    k = 1
    for _ in range(max_iters):
        power = spgemm_auto(power, a)
        if pattern:
            power = _pattern(power)
        k += 1
        new_total = add(total, power)
        if pattern:
            new_total = _pattern(new_total)
        if int(new_total.nnz) == int(total.nnz):
            return new_total, k
        total = new_total
    raise RuntimeError("reachability did not converge")


def _route_dense(n: int, dense: str) -> bool:
    from . import patterns

    if dense == "never":
        return False
    if dense == "always":
        assert patterns.fits(n), (n, patterns.MAX_PATTERN_N)
        return True
    assert dense == "auto", dense
    return patterns.fits(n)


def power_until_stable(a: SparseCSR, max_iters: int = 64,
                       pattern: bool = False,
                       dense: str = "auto") -> Tuple[SparseCSR, int]:
    """Repeated squaring until the sparsity pattern is a fixed point.

    Pattern mode takes the dense int8 matmul route when the frame fits
    (see :func:`reachability_sum`)."""
    if pattern and _route_dense(a.n_rows, dense):
        from . import patterns

        return patterns.power_until_stable(a, max_iters=max_iters)
    current = _pattern(a) if pattern else a
    k = 0
    for _ in range(max_iters):
        nxt = spgemm_auto(current, current)
        if pattern:
            nxt = _pattern(nxt)
        k += 1
        if bool(patterns_equal(nxt, current)):
            return nxt, k
        current = nxt
    raise RuntimeError("power_until_stable did not converge")


def connected_components_closure(a: SparseCSR,
                                 dense: str = "auto") -> np.ndarray:
    """Components via transitive closure (reference :578-600): add identity,
    square to fixed point, mutual reachability = same component.  Labels are
    sequential in order of first appearance (== ascending min-node id).

    Components are value-agnostic, so the dense int8 pattern route applies
    whenever the frame fits (and sidesteps the path-count overflow the
    sparse closure risks on dense components)."""
    if _route_dense(a.n_rows, dense):
        from . import patterns

        return patterns.connected_components_closure(a)
    n = a.n_rows
    with_id = add(a, SparseCSR.identity(n, sr=a.sr))
    closure, _ = power_until_stable(with_id)
    from ..ops.elementwise import spmul

    tc = closure.transpose(capacity=closure.capacity)
    mutual = spmul(closure, tc, out_cap=closure.capacity)
    # min column per row of `mutual` = component representative
    valid = jnp.arange(mutual.capacity) < mutual.nnz
    rows = mutual.row_of_slot()
    cols = jnp.where(valid, mutual.col_idx, jnp.int32(n))
    rep = jax.ops.segment_min(cols, rows, num_segments=n)
    rep = np.asarray(jax.device_get(rep))
    return _renumber(rep)


def connected_components(a: SparseCSR, max_iters: int = 64) -> np.ndarray:
    """Device min-label propagation with pointer jumping (undirected view).

    Vectorized replacement for the reference union-find (:605-651): converges
    in O(log n) rounds of gather + segment-min, entirely vectorized.
    """
    n = a.n_rows
    valid = np.arange(a.capacity) < int(a.nnz)
    rows = np.asarray(jax.device_get(a.row_of_slot()))[valid]
    cols = np.asarray(jax.device_get(a.col_idx))[valid]
    er = np.concatenate([rows, cols]).astype(np.int32)
    ec = np.concatenate([cols, rows]).astype(np.int32)
    er_j = jnp.asarray(er)
    ec_j = jnp.asarray(ec)

    @jax.jit
    def step(labels):
        nbr = labels[ec_j]
        cand = jax.ops.segment_min(nbr, er_j, num_segments=n)
        labels = jnp.minimum(labels, cand)
        # pointer jumping
        labels = jnp.minimum(labels, labels[labels])
        labels = jnp.minimum(labels, labels[labels])
        return labels

    labels = jnp.arange(n, dtype=jnp.int32)
    for _ in range(max_iters):
        new = step(labels)
        if bool(jnp.all(new == labels)):
            break
        labels = new
    return _renumber(np.asarray(jax.device_get(labels)))


def num_components(a: SparseCSR) -> int:
    return int(connected_components(a).max()) + 1 if a.n_rows else 0


def _renumber(rep: np.ndarray) -> np.ndarray:
    """Map representatives to sequential ids by first appearance."""
    _, inv = np.unique(rep, return_inverse=True)
    return inv.astype(np.int64)


def bandwidth_stats(a: SparseCSR) -> Tuple[int, float]:
    """(max |r-c|, mean |r-c|) over nonzeros (reference :806-818).

    Host int64 arithmetic: a device int32 sum of |r-c| wraps past 2^31
    (observed as a negative average at nell scale, n=65k / nnz=525k)."""
    rp, ci, _ = a.to_numpy()
    if len(ci) == 0:
        return 0, 0.0
    r = np.repeat(np.arange(a.n_rows, dtype=np.int64), np.diff(rp))
    d = np.abs(r - ci.astype(np.int64))
    return int(d.max()), float(d.mean())


def permute(a: SparseCSR, perm: np.ndarray) -> SparseCSR:
    """Reorder rows+cols by permutation with perm[new] = old (reference
    :724-776).  Returns a new matrix; pair with the same perm to undo."""
    n = a.n_rows
    perm = np.asarray(perm)
    inv = np.empty(n, np.int32)
    inv[perm] = np.arange(n, dtype=np.int32)
    inv_j = jnp.asarray(inv)
    valid = jnp.arange(a.capacity) < a.nnz
    r = jnp.where(valid, inv_j[jnp.clip(a.row_of_slot(), 0, n - 1)], n)
    c = jnp.where(valid, inv_j[jnp.clip(a.col_idx, 0, n - 1)], 0)
    return SparseCSR.from_coo_device(
        r, c, a.values, n, a.n_cols, a.sr, a.capacity, valid=valid
    )


def unpermute(a: SparseCSR, perm: np.ndarray) -> SparseCSR:
    perm = np.asarray(perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return permute(a, inv)


def rcm(a: SparseCSR) -> Tuple[SparseCSR, np.ndarray]:
    """Reverse Cuthill–McKee reordering (host BFS, reference :663-718).

    Returns (permuted matrix, perm) with perm[new] = old.  Used as a
    bandwidth reducer ahead of dense-band SpGEMM strategies.
    """
    n = a.n_rows
    row_ptr, col_idx, _ = a.to_numpy()
    visited = np.zeros(n, bool)
    order: List[int] = []
    deg = np.diff(row_ptr)

    from collections import deque

    seed = 0
    while len(order) < n:
        # smallest unvisited node as the next seed; a directed BFS from the
        # peripheral start may not cover the seed itself, so this is a while
        # loop rather than one pass over seeds (robustness fix over the
        # reference's for-loop, src/graph_csr.rs:670)
        while seed < n and visited[seed]:
            seed += 1
        if seed >= n:
            break
        # BFS from seed; last dequeued node approximates a peripheral node.
        # Track the last *globally-unvisited* node so that weakly-connected
        # directed graphs cannot restart from an already-ordered node
        # (latent in the reference, which only tests strongly-connected
        # directed graphs, src/graph_csr.rs:1133-1145).
        start = seed
        q = deque([seed])
        vis2 = np.zeros(n, bool)
        vis2[seed] = True
        while q:
            u = q.popleft()
            if not visited[u]:
                start = u
            for idx in range(row_ptr[u], row_ptr[u + 1]):
                v = int(col_idx[idx])
                if not vis2[v]:
                    vis2[v] = True
                    q.append(v)
        # main BFS from start, neighbors in ascending-degree order
        q = deque([start])
        visited[start] = True
        while q:
            u = q.popleft()
            order.append(u)
            nbrs = [
                int(col_idx[i])
                for i in range(row_ptr[u], row_ptr[u + 1])
                if not visited[int(col_idx[i])]
            ]
            nbrs.sort(key=lambda v: deg[v])
            for v in nbrs:
                if not visited[v]:
                    visited[v] = True
                    q.append(v)

    order.reverse()
    perm = np.asarray(order, np.int64)
    return permute(a, perm), perm


def diameter(a: SparseCSR, max_iters: int = 64, dense: str = "auto") -> int:
    """Graph diameter: squaring (A+I) to bracket, then linear refinement
    (reference src/graph_csr.rs:1228-1319).  Returns the max eccentricity
    bound found; assumes a connected graph.

    Routes through the dense int8 pattern engine when the frame fits —
    each squaring is one int8 matmul and each fixed-point loop one device
    dispatch (the sparse route pays an ESC dispatch + host sync per
    squaring)."""
    if _route_dense(a.n_rows, dense):
        from . import patterns

        return patterns.diameter(a, max_iters=max_iters)
    n = a.n_rows
    # pattern mode throughout: diameter is value-agnostic (nnz stability),
    # and path counts on dense closures overflow every exact value range
    base = _pattern(add(a, SparseCSR.identity(n, sr=a.sr)))
    # squaring phase: reach[k] covers paths of length <= 2^k
    powers = [base]
    steps = [1]
    current = base
    length = 1
    for _ in range(max_iters):
        nxt = _pattern(spgemm_auto(current, current))
        length *= 2
        if bool(patterns_equal(nxt, current)):
            break
        powers.append(nxt)
        steps.append(length)
        current = nxt
    # binary refinement: find smallest L with (A+I)^L full pattern of closure
    closure = current
    lo = steps[-1] // 2 if len(steps) > 1 else 0
    # walk down from the closure combining saved powers
    target_nnz = int(closure.nnz)
    # linear refinement from the last non-full power
    reach = powers[-1] if len(powers) > 0 else base
    d = steps[-1]
    if int(reach.nnz) == target_nnz and len(powers) > 1:
        reach = powers[-2]
        d = steps[-2]
    while int(reach.nnz) != target_nnz:
        reach = _pattern(spgemm_auto(reach, base))
        d += 1
    return d
