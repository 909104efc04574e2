"""Device-resident CSR sparse matrix as a JAX pytree.

Accelerator re-design of the reference's ``CsrMatrix`` (src/graph_csr.rs:42-57)
and shape-generalized ``Csr<I,V>`` (linalg/src/csr.rs:87-130): row_ptr /
col_idx / values live as jnp arrays so every kernel is jit-able, and the
value array is a tuple of uint32/float32 limb arrays per the semiring
(see semiring.py).

XLA requires static shapes, so the entry arrays are sized to a static
``capacity >= nnz``; entries [0, nnz) are valid, sorted by (row, col), and the
padded tail carries ``row = n_rows`` / ``col = sentinel`` / ``value = 0`` so
that padded elements sort last and vanish under reductions.

Capacity is part of the pytree *structure* (array shape), so re-jitting
happens per capacity bucket — the chain driver rounds capacities to powers
of two to bound recompilation.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .semiring import Semiring, U64, Value, by_name
from .ops import segments
from .ops.segments import INT32_SENTINEL


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["row_ptr", "col_idx", "values", "nnz"],
    meta_fields=["n_rows", "n_cols", "sr_name"],
)
@dataclasses.dataclass(frozen=True)
class SparseCSR:
    """n_rows x n_cols sparse matrix, CSR, semiring-valued, statically padded."""

    row_ptr: jnp.ndarray  # int32[n_rows + 1]
    col_idx: jnp.ndarray  # int32[capacity], padded tail = INT32_SENTINEL
    values: Value         # tuple of sr.nlimbs arrays [capacity]
    nnz: jnp.ndarray      # int32 scalar (device)
    n_rows: int
    n_cols: int
    sr_name: str

    # -- static views --------------------------------------------------------
    @property
    def sr(self) -> Semiring:
        return by_name(self.sr_name)

    @property
    def capacity(self) -> int:
        return self.col_idx.shape[0]

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_cols)

    def row_of_slot(self) -> jnp.ndarray:
        """int32[capacity]: row index of each entry slot (n_rows for padding).

        scatter + cummax, not searchsorted: binary search with capacity-many
        consecutive queries costs log2(n) random-gather passes over the
        whole slot stream; the
        scatter-row-starts + running-max formulation is one n_rows-sized
        scatter plus one scan."""
        slots = jnp.arange(self.capacity, dtype=jnp.int32)
        rows = segments.repeat_index(
            self.row_ptr[:-1], jnp.arange(self.n_rows, dtype=jnp.int32),
            self.capacity,
        )
        return jnp.where(slots < self.nnz, rows, jnp.int32(self.n_rows))

    def row_nnz(self) -> jnp.ndarray:
        return self.row_ptr[1:] - self.row_ptr[:-1]

    # -- conversion ----------------------------------------------------------
    def to_dense(self) -> Tuple[jnp.ndarray, ...]:
        """Dense (n_rows, n_cols) limb arrays; padded entries dropped."""
        valid = jnp.arange(self.capacity) < self.nnz
        r = jnp.where(valid, self.row_of_slot(), self.n_rows)
        c = jnp.where(valid, self.col_idx, self.n_cols)
        outs = []
        for limb in self.values:
            d = jnp.zeros((self.n_rows, self.n_cols), limb.dtype)
            outs.append(d.at[r, c].add(jnp.where(valid, limb, 0), mode="drop"))
        return tuple(outs)

    def to_numpy(self):
        """Host-side (row_ptr, col_idx, values) with values as uint64/float numpy."""
        nnz = int(self.nnz)
        row_ptr = np.asarray(jax.device_get(self.row_ptr))
        col_idx = np.asarray(jax.device_get(self.col_idx))[:nnz]
        vals = self.sr.to_numpy(tuple(l[:nnz] for l in self.values))
        return row_ptr, col_idx, vals

    def to_dense_numpy(self):
        nnz = int(self.nnz)
        row_ptr, col_idx, vals = self.to_numpy()
        out = np.zeros((self.n_rows, self.n_cols), dtype=vals.dtype)
        rows = np.repeat(np.arange(self.n_rows), np.diff(row_ptr))
        out[rows, col_idx] = vals
        return out

    # -- construction --------------------------------------------------------
    @staticmethod
    def empty(n_rows: int, n_cols: int, capacity: int, sr: Semiring) -> "SparseCSR":
        return SparseCSR(
            row_ptr=jnp.zeros((n_rows + 1,), jnp.int32),
            col_idx=jnp.full((capacity,), INT32_SENTINEL, jnp.int32),
            values=sr.zeros((capacity,)),
            nnz=jnp.zeros((), jnp.int32),
            n_rows=n_rows,
            n_cols=n_cols,
            sr_name=sr.name,
        )

    @staticmethod
    def identity(n: int, capacity: Optional[int] = None, sr: Semiring = U64) -> "SparseCSR":
        cap = capacity or n
        assert cap >= n
        idx = jnp.arange(n, dtype=jnp.int32)
        col = jnp.full((cap,), INT32_SENTINEL, jnp.int32).at[idx].set(idx)
        ones = sr.ones((n,))
        values = tuple(
            jnp.zeros((cap,), sr.dtype).at[idx].set(l) for l in ones
        )
        return SparseCSR(
            row_ptr=jnp.arange(n + 1, dtype=jnp.int32),
            col_idx=col,
            values=values,
            nnz=jnp.asarray(n, jnp.int32),
            n_rows=n,
            n_cols=n,
            sr_name=sr.name,
        )

    @staticmethod
    def from_coo_device(
        rows: jnp.ndarray,
        cols: jnp.ndarray,
        values: Value,
        n_rows: int,
        n_cols: int,
        sr: Semiring,
        capacity: int,
        valid: Optional[jnp.ndarray] = None,
    ) -> "SparseCSR":
        """Device-side COO->CSR: sort by (row, col), merge duplicates with
        saturating add, drop explicit zeros (reference from_coo,
        src/graph_csr.rs:85-129).  jit-friendly; all shapes static.

        ``values`` may carry FEWER limbs than the semiring (the narrow u64
        fast path, ops/spgemm.expand_products): the merge reconstructs the
        missing hi limb from plane carries, so outputs are always full."""
        m = rows.shape[0]
        if valid is None:
            valid = jnp.ones((m,), bool)
        v = tuple(jnp.where(valid, l, jnp.zeros((), l.dtype))
                  for l in values)
        slot = jnp.arange(capacity, dtype=jnp.int32)
        if (n_rows + 1) * n_cols < 2**31:
            # fused (row * n_cols + col) int32 key: single-key sort
            key = jnp.where(
                valid,
                rows.astype(jnp.int32) * jnp.int32(n_cols) + cols.astype(jnp.int32),
                INT32_SENTINEL,
            )
            keys, payload = segments.sort_by_keys([key], list(v))
            valid_sorted = keys[0] != INT32_SENTINEL
            out_keys, out_vals, nnz = segments.reduce_sorted_coo(
                sr, keys, tuple(payload), valid_sorted, capacity,
                key_fills=[INT32_SENTINEL],
            )
            in_range = slot < nnz
            fused = out_keys[0]
            out_rows = jnp.where(in_range, fused // jnp.int32(n_cols), jnp.int32(n_rows))
            col_idx = jnp.where(in_range, fused % jnp.int32(n_cols), INT32_SENTINEL)
        else:
            # two-key lexicographic sort; invalid entries get sentinel keys
            r = jnp.where(valid, rows.astype(jnp.int32), jnp.int32(n_rows))
            c = jnp.where(valid, cols.astype(jnp.int32), INT32_SENTINEL)
            keys, payload = segments.sort_by_keys([r, c], list(v))
            valid_sorted = keys[0] < n_rows
            out_keys, out_vals, nnz = segments.reduce_sorted_coo(
                sr, keys, tuple(payload), valid_sorted, capacity,
                key_fills=[jnp.int32(n_rows), INT32_SENTINEL],
            )
            out_rows = out_keys[0]
            col_idx = jnp.where(slot < nnz, out_keys[1], INT32_SENTINEL)
        row_ptr = jnp.searchsorted(
            out_rows, jnp.arange(n_rows + 1, dtype=jnp.int32), side="left"
        ).astype(jnp.int32)
        # capacity overflow poisons nnz to -1 so host code fails loudly
        # instead of returning a silently-truncated matrix
        nnz_out = jnp.where(nnz <= capacity, nnz, -1).astype(jnp.int32)
        return SparseCSR(
            row_ptr=row_ptr,
            col_idx=col_idx,
            values=out_vals,
            nnz=nnz_out,
            n_rows=n_rows,
            n_cols=n_cols,
            sr_name=sr.name,
        )

    @staticmethod
    def from_coo(
        rows,
        cols,
        vals,
        n_rows: int,
        n_cols: Optional[int] = None,
        sr: Semiring = U64,
        capacity: Optional[int] = None,
    ) -> "SparseCSR":
        """Host-friendly COO->CSR from numpy arrays / lists."""
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        n_cols = n_rows if n_cols is None else n_cols
        vals_v = sr.from_numpy(np.asarray(vals))
        cap = capacity or max(int(rows.shape[0]), 1)
        if rows.shape[0] == 0:
            return SparseCSR.empty(n_rows, n_cols, cap, sr)
        return SparseCSR.from_coo_device(
            jnp.asarray(rows, jnp.int32),
            jnp.asarray(cols, jnp.int32),
            vals_v,
            n_rows,
            n_cols,
            sr,
            cap,
        )

    @staticmethod
    def host_csr_arrays(
        rows,
        cols,
        vals,
        n_rows: int,
        n_cols: Optional[int] = None,
        sr: Semiring = U64,
        capacity: Optional[int] = None,
    ):
        """Pure-numpy COO->CSR merge (no jax — safe to run in a thread while
        the main thread starts the device).  Returns
        ``(row_ptr i32[n+1], col_idx i32[cap], limbs list[np arrays[cap]],
        nnz)``; see from_coo_host for the device version."""
        n_cols = n_rows if n_cols is None else n_cols
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals)
        if rows.size:
            order = np.lexsort((cols, rows))
            rows, cols, vals = rows[order], cols[order], vals[order]
            key = rows * n_cols + cols
            head = np.ones(len(key), bool)
            head[1:] = key[1:] != key[:-1]
            seg = np.cumsum(head) - 1
            if sr.name == "f32":
                totals = np.zeros(seg[-1] + 1, np.float64)
                np.add.at(totals, seg, vals.astype(np.float64))
                totals = totals.astype(np.float32)
            else:
                totals = np.zeros(seg[-1] + 1, dtype=object)
                np.add.at(totals, seg, vals.astype(np.uint64).astype(object))
                sat = (1 << 64) - 1 if sr.name == "u64" else (1 << 32) - 1
                totals = np.minimum(totals, sat).astype(np.uint64)
            rows, cols = rows[head], cols[head]
            keep = totals != 0
            rows, cols, totals = rows[keep], cols[keep], totals[keep]
        else:
            totals = vals
        nnz = len(rows)
        cap = capacity or max(nnz, 1)
        assert cap >= nnz, (cap, nnz)
        col_idx = np.full(cap, int(INT32_SENTINEL), np.int32)
        col_idx[:nnz] = cols
        row_ptr = np.zeros(n_rows + 1, np.int64)
        np.add.at(row_ptr, rows + 1, 1)
        row_ptr = np.cumsum(row_ptr).astype(np.int32)
        limbs_np = [
            np.concatenate([l, np.zeros(cap - nnz, l.dtype)])
            for l in sr.to_host_limbs(totals)
        ]
        return row_ptr, col_idx, limbs_np, nnz

    @staticmethod
    def from_host_arrays(row_ptr, col_idx, limbs_np, nnz, n_rows: int,
                         n_cols: int, sr: Semiring) -> "SparseCSR":
        """Device_put of host_csr_arrays output."""
        return SparseCSR(
            row_ptr=jnp.asarray(row_ptr),
            col_idx=jnp.asarray(col_idx),
            values=tuple(jnp.asarray(l) for l in limbs_np),
            nnz=jnp.asarray(nnz, jnp.int32),
            n_rows=n_rows,
            n_cols=n_cols,
            sr_name=sr.name,
        )

    @staticmethod
    def from_coo_host(
        rows,
        cols,
        vals,
        n_rows: int,
        n_cols: Optional[int] = None,
        sr: Semiring = U64,
        capacity: Optional[int] = None,
    ) -> "SparseCSR":
        """Host-side COO->CSR (numpy lexsort + saturating merge), then one
        device_put.  Same semantics as from_coo; avoids the device sort
        round-trip for host-generated graphs (generation is host-side in the
        reference too, src/graph.rs:90-139)."""
        n_cols = n_rows if n_cols is None else n_cols
        row_ptr, col_idx, limbs_np, nnz = SparseCSR.host_csr_arrays(
            rows, cols, vals, n_rows, n_cols, sr, capacity
        )
        return SparseCSR.from_host_arrays(
            row_ptr, col_idx, limbs_np, nnz, n_rows, n_cols, sr
        )

    @staticmethod
    def from_dense_device(limbs, sr: Semiring, capacity: Optional[int] = None) -> "SparseCSR":
        """Device-side dense (n, m) limb tuple -> SparseCSR with no host
        round-trip beyond one scalar nnz sync (to size the static capacity;
        pass ``capacity`` to avoid even that).  The flattened nonzero scan
        yields (row, col) already sorted, so row_ptr comes from one
        searchsorted instead of a full COO sort — the streaming-build role
        of the reference's CsrBuilder (src/graph_csr_builder.rs:12-51)."""
        limbs = tuple(jnp.asarray(l) for l in limbs)
        n, m = limbs[0].shape
        mask = limbs[0] != 0
        for l in limbs[1:]:
            mask = mask | (l != 0)
        if capacity is None:
            capacity = max(int(jnp.count_nonzero(mask)), 1)
        flat = mask.reshape(-1)
        idx = jnp.nonzero(flat, size=capacity, fill_value=n * m)[0]
        valid = idx < n * m
        safe = jnp.clip(idx, 0, n * m - 1)
        r = jnp.where(valid, (safe // m).astype(jnp.int32), jnp.int32(n))
        c = jnp.where(valid, (safe % m).astype(jnp.int32), INT32_SENTINEL)
        vals = tuple(
            jnp.where(valid, l.reshape(-1)[safe], jnp.zeros((), l.dtype))
            for l in limbs
        )
        nnz = jnp.count_nonzero(valid).astype(jnp.int32)
        # undersized capacity truncates jnp.nonzero silently — poison nnz
        # to -1 (the u64-saturating overflow discipline, .check() raises)
        true_nnz = jnp.count_nonzero(mask).astype(jnp.int32)
        nnz = jnp.where(true_nnz > capacity, jnp.int32(-1), nnz)
        row_ptr = jnp.searchsorted(
            r, jnp.arange(n + 1, dtype=jnp.int32), side="left"
        ).astype(jnp.int32)
        return SparseCSR(
            row_ptr=row_ptr, col_idx=c, values=vals, nnz=nnz,
            n_rows=n, n_cols=m, sr_name=sr.name,
        )

    @staticmethod
    def from_dense_numpy(dense, sr: Semiring = U64, capacity: Optional[int] = None) -> "SparseCSR":
        dense = np.asarray(dense)
        r, c = np.nonzero(dense)
        return SparseCSR.from_coo(
            r, c, dense[r, c], dense.shape[0], dense.shape[1], sr, capacity
        )

    def memory_bytes(self) -> int:
        """Self-reported device storage (reference estimate_memory_usage,
        src/dense.rs:170, src/chunked.rs:166-170): row_ptr + col_idx +
        value limbs at the current static capacity."""
        limb_bytes = sum(l.dtype.itemsize for l in self.values)
        return int(
            self.row_ptr.size * 4 + self.capacity * (4 + limb_bytes)
        )

    def check(self) -> "SparseCSR":
        """Host-side guard: raise if a capacity overflow poisoned this matrix."""
        if int(self.nnz) < 0:
            raise ValueError(
                "SparseCSR capacity overflow: an operation produced more "
                "entries than its static capacity (nnz poisoned to -1); "
                "re-run with a larger capacity / expand_cap"
            )
        return self

    # -- resizing ------------------------------------------------------------
    def with_capacity(self, capacity: int) -> "SparseCSR":
        """Pad or (validly) shrink the entry arrays to a new static capacity."""
        cap0 = self.capacity
        if capacity == cap0:
            return self
        if capacity > cap0:
            pad = capacity - cap0
            col = jnp.concatenate(
                [self.col_idx, jnp.full((pad,), INT32_SENTINEL, jnp.int32)]
            )
            vals = tuple(
                jnp.concatenate([l, jnp.zeros((pad,), l.dtype)]) for l in self.values
            )
        else:
            col = self.col_idx[:capacity]
            vals = tuple(l[:capacity] for l in self.values)
        return dataclasses.replace(self, col_idx=col, values=vals)

    # -- simple ops ----------------------------------------------------------
    def get(self, r: int, c: int):
        """Host-side scalar lookup (binary search), for tests/debug."""
        row_ptr, col_idx, vals = self.to_numpy()
        s, e = int(row_ptr[r]), int(row_ptr[r + 1])
        i = np.searchsorted(col_idx[s:e], c)
        if i < e - s and col_idx[s + i] == c:
            return vals[s + i]
        return type(vals[0])(0) if len(vals) else 0

    def lookup(self, rows, cols) -> Value:
        """Vectorized device-side coordinate lookup: limb values at
        (rows[i], cols[i]), zeros where absent.  Per-query binary search of
        the row's col_idx segment — static log2(capacity) iterations of
        vectorized gathers, all queries in parallel; the device analog of
        ``get`` and of the reference's binary-search accessor
        (src/graph_csr.rs:250-257).  Out-of-range rows return zeros."""
        rows = jnp.asarray(rows, jnp.int32)
        cols = jnp.asarray(cols, jnp.int32)
        ok_r = (rows >= 0) & (rows < self.n_rows)
        r_safe = jnp.clip(rows, 0, self.n_rows - 1)
        lo0 = jnp.where(ok_r, self.row_ptr[r_safe], 0)
        hi0 = jnp.where(ok_r, self.row_ptr[r_safe + 1], 0)
        n_iter = max(self.capacity.bit_length(), 1)

        def body(_, lh):
            lo, hi = lh
            act = lo < hi
            mid = (lo + hi) // 2
            v = self.col_idx[jnp.clip(mid, 0, self.capacity - 1)]
            go = v < cols
            lo = jnp.where(act & go, mid + 1, lo)
            hi = jnp.where(act & ~go, mid, hi)
            return lo, hi

        lo, _ = jax.lax.fori_loop(0, n_iter, body, (lo0, hi0))
        pos = jnp.clip(lo, 0, self.capacity - 1)
        hit = ok_r & (lo < hi0) & (self.col_idx[pos] == cols)
        return tuple(
            jnp.where(hit, l[pos], jnp.zeros((), l.dtype))
            for l in self.values
        )

    def transpose(self, capacity: Optional[int] = None) -> "SparseCSR":
        cap = capacity or self.capacity
        valid = jnp.arange(self.capacity) < self.nnz
        return SparseCSR.from_coo_device(
            self.col_idx, self.row_of_slot(), self.values,
            self.n_cols, self.n_rows, self.sr, cap, valid=valid,
        )
