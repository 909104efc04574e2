"""Semiring value abstraction for sparse linear algebra on an accelerator.

The reference framework parameterizes every kernel over an (Index, Value)
semiring pair with saturating integer arithmetic (reference:
linalg/src/csr.rs:38-85, src/graph_csr.rs:29-37).  JAX runs without 64-bit
integers unless x64 mode is enabled, and accelerators' vector datapaths are
32-bit, so semiring values are a *tuple of uint32 limb arrays* with exact
saturating arithmetic in 32-bit vector ops:

  - ``U32Sat``: one uint32 limb, saturating add/mul (``Saturating<u32>``).
  - ``U64Sat``: two uint32 limbs (lo, hi), saturating add/mul over the full
    128-bit product (``Saturating<u64>``).
  - ``F32``:    one float32 limb, ordinary IEEE add/mul.

All operations are elementwise jnp ops and work identically on the CPU and
a GPU without enabling jax x64 mode.  Values travel through sorts,
scans and gathers as flat tuples of same-shaped arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Value = Tuple[jnp.ndarray, ...]

_U32_MAX = np.uint32(0xFFFFFFFF)


def _u32(x):
    return jnp.asarray(x, dtype=jnp.uint32)


def _umull32(a, b):
    """Full 32x32 -> 64-bit product of uint32 arrays, as (lo, hi) uint32."""
    mask = _u32(0xFFFF)
    a0 = a & mask
    a1 = a >> 16
    b0 = b & mask
    b1 = b >> 16
    ll = a0 * b0
    t = a1 * b0 + (ll >> 16)
    w1 = t & mask
    w2 = t >> 16
    t2 = a0 * b1 + w1
    hi = a1 * b1 + w2 + (t2 >> 16)
    lo = (t2 << 16) | (ll & mask)
    return lo, hi


class Semiring:
    """Base class: a commutative semiring with saturating add/mul on limbed values."""

    name: str = "abstract"
    nlimbs: int = 0
    dtype = jnp.uint32

    # -- construction -------------------------------------------------------
    def zeros(self, shape) -> Value:
        return tuple(jnp.zeros(shape, self.dtype) for _ in range(self.nlimbs))

    def ones(self, shape) -> Value:
        raise NotImplementedError

    def full(self, shape, scalar: int | float) -> Value:
        one_elem = self.from_numpy(np.asarray([scalar]))
        return tuple(jnp.full(shape, np.asarray(l)[0], self.dtype) for l in one_elem)

    # -- conversion ---------------------------------------------------------
    def from_numpy(self, x) -> Value:
        raise NotImplementedError

    def to_numpy(self, v: Value):
        raise NotImplementedError

    def to_host_limbs(self, x):
        """numpy value array -> list of numpy limb arrays (host-side builds)."""
        raise NotImplementedError

    # -- arithmetic ---------------------------------------------------------
    def add(self, x: Value, y: Value) -> Value:
        raise NotImplementedError

    def mul(self, x: Value, y: Value) -> Value:
        raise NotImplementedError

    # -- structure ----------------------------------------------------------
    def is_zero(self, v: Value) -> jnp.ndarray:
        out = v[0] == 0
        for l in v[1:]:
            out = out & (l == 0)
        return out

    def equal(self, x: Value, y: Value) -> jnp.ndarray:
        out = x[0] == y[0]
        for a, b in zip(x[1:], y[1:]):
            out = out & (a == b)
        return out

    def where(self, mask, x: Value, y: Value) -> Value:
        return tuple(jnp.where(mask, a, b) for a, b in zip(x, y))

    def gather(self, v: Value, idx) -> Value:
        return tuple(l[idx] for l in v)

    def __repr__(self):
        return f"Semiring({self.name})"


class U32Sat(Semiring):
    """Saturating u32 semiring (reference CsrMatrix Val, src/graph_csr.rs:17)."""

    name = "u32"
    nlimbs = 1
    dtype = jnp.uint32

    def ones(self, shape) -> Value:
        return (jnp.ones(shape, jnp.uint32),)

    def from_numpy(self, x) -> Value:
        x = np.asarray(x, dtype=np.uint64)
        if np.any(x > 0xFFFFFFFF):
            raise ValueError("value out of u32 range")
        return (jnp.asarray(x.astype(np.uint32)),)

    def to_numpy(self, v: Value):
        return np.asarray(jax.device_get(v[0])).astype(np.uint64)

    def add(self, x: Value, y: Value) -> Value:
        s = x[0] + y[0]
        return (jnp.where(s < x[0], _U32_MAX, s),)

    def mul(self, x: Value, y: Value) -> Value:
        lo, hi = _umull32(x[0], y[0])
        return (jnp.where(hi > 0, _U32_MAX, lo),)

    def to_host_limbs(self, x):
        x = np.asarray(x, dtype=np.uint64)
        if np.any(x > 0xFFFFFFFF):
            raise ValueError("value out of u32 range")
        return [x.astype(np.uint32)]


class U64Sat(Semiring):
    """Saturating u64 semiring as two uint32 limbs (lo, hi).

    Matches Rust ``Saturating<u64>`` semantics exactly: add saturates on
    65-bit carry-out, mul saturates when the true 128-bit product >= 2^64.
    """

    name = "u64"
    nlimbs = 2
    dtype = jnp.uint32

    def ones(self, shape) -> Value:
        return (jnp.ones(shape, jnp.uint32), jnp.zeros(shape, jnp.uint32))

    def from_numpy(self, x) -> Value:
        x = np.asarray(x, dtype=np.uint64)
        lo = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (x >> np.uint64(32)).astype(np.uint32)
        return (jnp.asarray(lo), jnp.asarray(hi))

    def to_numpy(self, v: Value):
        lo = np.asarray(jax.device_get(v[0])).astype(np.uint64)
        hi = np.asarray(jax.device_get(v[1])).astype(np.uint64)
        return lo | (hi << np.uint64(32))

    def add(self, x: Value, y: Value) -> Value:
        alo, ahi = x
        blo, bhi = y
        lo = alo + blo
        carry = (lo < alo).astype(jnp.uint32)
        h1 = ahi + bhi
        c1 = h1 < ahi
        hi = h1 + carry
        ovf = c1 | (hi < h1)
        return (jnp.where(ovf, _U32_MAX, lo), jnp.where(ovf, _U32_MAX, hi))

    def mul(self, x: Value, y: Value) -> Value:
        alo, ahi = x
        blo, bhi = y
        l00, h00 = _umull32(alo, blo)
        l01, h01 = _umull32(alo, bhi)
        l10, h10 = _umull32(ahi, blo)
        s1 = h00 + l01
        c1 = s1 < h00
        s2 = s1 + l10
        c2 = s2 < s1
        ovf = (h01 != 0) | (h10 != 0) | ((ahi != 0) & (bhi != 0)) | c1 | c2
        return (jnp.where(ovf, _U32_MAX, l00), jnp.where(ovf, _U32_MAX, s2))

    def to_host_limbs(self, x):
        x = np.asarray(x, dtype=np.uint64)
        lo = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (x >> np.uint64(32)).astype(np.uint32)
        return [lo, hi]


class F32(Semiring):
    """Plain float32 semiring (reference float Value, linalg/src/csr.rs:74-85)."""

    name = "f32"
    nlimbs = 1
    dtype = jnp.float32

    def ones(self, shape) -> Value:
        return (jnp.ones(shape, jnp.float32),)

    def from_numpy(self, x) -> Value:
        return (jnp.asarray(np.asarray(x, dtype=np.float32)),)

    def to_numpy(self, v: Value):
        return np.asarray(jax.device_get(v[0])).astype(np.float32)

    def add(self, x: Value, y: Value) -> Value:
        return (x[0] + y[0],)

    def mul(self, x: Value, y: Value) -> Value:
        return (x[0] * y[0],)

    def to_host_limbs(self, x):
        return [np.asarray(x, dtype=np.float32)]


U32 = U32Sat()
U64 = U64Sat()
F32SR = F32()

_BY_NAME = {"u32": U32, "u64": U64, "f32": F32SR}


def by_name(name: str) -> Semiring:
    return _BY_NAME[name]
