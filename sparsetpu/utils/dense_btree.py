"""Flat-array K-ary search tree (host-side index experiment).

Parity component for the reference's DenseBTree/DenseBTreeList
(src/dense_btree.rs:9-331): a cache-friendly drop-in for binary search over
sorted u32 keys, packing the implicit K=16-ary tree level by level in flat
arrays.  On the device the CSR row lookup is a vectorized searchsorted, so
this structure is host-side; it exists for the row-index-acceleration
experiment (CsrBTree) and its storage-overhead study (the reference's
sawtooth -> 1/(K-1) ~ 6.67% asymptote).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

K = 16  # keys per node (reference KEYS_PER_NODE, src/dense_btree.rs:2)


@dataclasses.dataclass
class DenseBTree:
    """Search index over a sorted key array.

    Level with stride s holds the block maxima ``keys[s-1::s]``; levels are
    stored root (largest stride) first.  A lookup narrows the window by a
    factor of K per level, touching one small contiguous slice each time.
    """

    keys: np.ndarray            # sorted leaf keys
    levels: List[np.ndarray]    # root-first separator arrays
    strides: List[int]

    @staticmethod
    def from_sorted(keys) -> "DenseBTree":
        keys = np.ascontiguousarray(keys, np.uint32)
        levels: List[np.ndarray] = []
        strides: List[int] = []
        s = K
        while len(keys) // s > 0 and len(keys) > K:
            lvl = keys[s - 1 :: s]
            if len(lvl) == 0:
                break
            levels.append(lvl)
            strides.append(s)
            if len(lvl) <= K:
                break
            s *= K
        levels.reverse()
        strides.reverse()
        return DenseBTree(keys, levels, strides)

    def index(self, key) -> Optional[int]:
        """Position of `key` in the sorted array, or None (drop-in for the
        binary-search contract)."""
        lo, hi = 0, len(self.keys)
        for lvl, s in zip(self.levels, self.strides):
            s0 = lo // s
            s1 = min(len(lvl), -(-hi // s))
            pos = s0 + int(np.searchsorted(lvl[s0:s1], key, side="left"))
            lo = max(lo, pos * s)
            hi = min(hi, (pos + 1) * s)
            if lo >= hi:
                break
        i = lo + int(np.searchsorted(self.keys[lo:hi], key, side="left"))
        if i < len(self.keys) and self.keys[i] == key:
            return i
        return None

    def overhead(self) -> float:
        """Extra storage as a fraction of the leaf array
        (the reference's sawtooth study)."""
        extra = sum(len(l) for l in self.levels)
        return extra / max(len(self.keys), 1)


@dataclasses.dataclass
class DenseBTreeList:
    """Many per-row indexes packed with cumulative offsets (reference
    DenseBTreeList data_start packing)."""

    trees: List[DenseBTree]
    data_start: np.ndarray

    @staticmethod
    def from_rows(rows: Sequence[np.ndarray]) -> "DenseBTreeList":
        starts = np.zeros(len(rows) + 1, np.int64)
        trees = []
        for i, r in enumerate(rows):
            trees.append(DenseBTree.from_sorted(r))
            starts[i + 1] = starts[i] + len(r)
        return DenseBTreeList(trees, starts)

    def index(self, row: int, key) -> Optional[int]:
        local = self.trees[row].index(key)
        if local is None:
            return None
        return int(self.data_start[row]) + local


# ---------------------------------------------------------------------------
# device-side K-ary lookup (the CsrBTree row-index experiment)
# ---------------------------------------------------------------------------

def build_device_btree(keys: np.ndarray):
    """Pack a sorted uint32 key array into the flat K-ary level layout on
    device.  Keys are padded to a power of K with 0xFFFFFFFF sentinels so a
    node's K separators are one contiguous (Q, K) gather per level — the
    device translation of the reference's cache-line-friendly node layout
    (src/dense_btree.rs:9-331).  Returns (levels root-first, padded keys);
    queries must be < 0xFFFFFFFF."""
    import jax.numpy as jnp

    keys = np.ascontiguousarray(keys, np.uint32)
    n = max(len(keys), 1)
    depth = 1
    while K ** depth < n:
        depth += 1
    padded = np.full(K ** depth, np.uint32(0xFFFFFFFF))
    padded[: len(keys)] = keys
    levels = []
    s = K
    while s < len(padded):
        levels.append(jnp.asarray(padded[s - 1 :: s]))
        s *= K
    levels.reverse()  # root (K separators) first
    return levels, jnp.asarray(padded)


def btree_lookup_device(levels, keys, q):
    """Vectorized K-ary descent: per level one (Q, K) contiguous gather +
    a compare/sum, vs binary search's log2(n) scattered (Q,) gathers.
    Returns (pos, hit) like searchsorted + equality."""
    import jax.numpy as jnp

    node = jnp.zeros(q.shape, jnp.int32)
    offs = jnp.arange(K, dtype=jnp.int32)[None, :]
    for lvl in levels:
        base = node * K
        vals = lvl[base[:, None] + offs]          # (Q, K) contiguous
        cnt = jnp.sum(vals < q[:, None], axis=1).astype(jnp.int32)
        node = base + cnt
    base = node * K
    vals = keys[base[:, None] + offs]
    cnt = jnp.sum(vals < q[:, None], axis=1).astype(jnp.int32)
    pos = base + cnt
    hit = keys[jnp.clip(pos, 0, keys.shape[0] - 1)] == q
    return pos, hit


def overhead_sweep(max_n: int = 10000, step: int = 117) -> str:
    """CSV of storage overhead vs n (btree_overhead.csv analog)."""
    lines = ["n,overhead"]
    for n in range(1, max_n, step):
        t = DenseBTree.from_sorted(np.arange(n, dtype=np.uint32))
        lines.append(f"{n},{t.overhead():.6f}")
    return "\n".join(lines) + "\n"
