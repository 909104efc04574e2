"""Block-band matrix format + dense band SpGEMM.

Accelerator replacement for the reference's cache-blocked SpGEMM strategies
(MAGNUS row categorization, src/graph_magnus.rs; AVX2 block kernels,
src/chunked.rs:12-131): matrices whose nonzeros live in a (cyclic) band —
Moore-lattice tori natively, arbitrary graphs after RCM — are stored as
dense *block diagonals* and multiplied with batched dense block matmuls.  Entries outside the band are "outliers" and take the ESC sparse path;
:mod:`sparsetpu.ops.hybrid` merges the two — that split is the per-entry
categorization pass.

Block-band storage: for block size B and block half-width Wb,
``data[I, D]`` is the dense BxB block at block-row I, block-col
(I + D - Wb) (mod nb if cyclic, else clipped).  A band matmul is then a
block-diagonal convolution:

    C[I, Dp + Da] += P[I, Dp] @ A[(I + Dp - Wbp) % nb, Da]

i.e. Kbp * Kba batched (nb, B, B) matmuls — pure dense matmul work with static
shapes.  Exactness: values are integer counts carried in f32; products and
sums are exact while results stay < 2^24 (guarded by the caller via
value-bound checks; see ops/hybrid.py).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..csr import SparseCSR
from ..semiring import Semiring, U64


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["data"],
    meta_fields=["n", "block", "half_width_blocks", "cyclic"],
)
@dataclasses.dataclass(frozen=True)
class BandMatrix:
    """Dense block-band matrix: data[I, D, r, c] = M[I*B + r, col],
    col = (I + D - Wb) * B + c, cyclic mod n or clipped."""

    data: jnp.ndarray  # f32[nb, K, B, B]
    n: int             # logical size (== nb * B when cyclic)
    block: int
    half_width_blocks: int
    cyclic: bool

    @property
    def nb(self) -> int:
        return self.data.shape[0]

    @property
    def k_blocks(self) -> int:
        return self.data.shape[1]

    @property
    def half_width(self) -> int:
        # guaranteed coverage in element terms
        return self.half_width_blocks * self.block

    def nnz(self) -> jnp.ndarray:
        return jnp.sum((self.data != 0).astype(jnp.int32))

    def memory_bytes(self) -> int:
        return int(self.data.size * self.data.dtype.itemsize)

    def max_value(self) -> jnp.ndarray:
        return jnp.max(self.data)


def _block_col(I: np.ndarray, D: np.ndarray, wb: int, nb: int, cyclic: bool):
    J = I + D - wb
    if cyclic:
        return np.mod(J, nb), np.ones_like(J, bool)
    return J, (J >= 0) & (J < nb)


def band_params(n: int, half_width: int, block: int, cyclic: bool):
    """(nb, Wb) for a given element half-width. Cyclic requires block | n."""
    if cyclic:
        assert n % block == 0, f"cyclic band needs block | n ({block} vs {n})"
        nb = n // block
    else:
        nb = -(-n // block)
    wb = -(-half_width // block) + 1  # +1: element offset within the block row
    return nb, wb


def cyclic_bandwidth(a: SparseCSR) -> int:
    """Max cyclic column offset |c - r| mod n over all entries.

    Note: a Moore *torus* lattice's cyclic bandwidth exceeds the naive
    stride sum — inner-dimension wraps contribute stride_i*(d_i - 1)
    (e.g. 30^3: 900 + 870 + 29 = 1799, not 931)."""
    n = a.n_rows
    row_ptr, col_idx, _ = a.to_numpy()
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(row_ptr))
    delta = col_idx.astype(np.int64) - rows
    dc = np.minimum(np.mod(delta, n), np.mod(-delta, n))
    return int(dc.max(initial=0))


def csr_band_split(a: SparseCSR, half_width: int, block: int = 128,
                   cyclic: bool = False):
    """Host-side split of a CSR matrix into (BandMatrix, outlier SparseCSR).

    An entry (r, c) is in-band when its (cyclic) column offset from r is
    within ``half_width``; everything else becomes the outlier CSR (the
    per-entry categorization pass).
    """
    assert a.n_rows == a.n_cols
    n = a.n_rows
    nb, wb = band_params(n, half_width, block, cyclic)
    kb = min(2 * wb + 1, nb) if cyclic else 2 * wb + 1

    row_ptr, col_idx, vals = a.to_numpy()
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(row_ptr))
    cols = col_idx.astype(np.int64)

    I = rows // block
    J = cols // block
    if cyclic:
        D = np.mod(J - I + wb, nb)
    else:
        D = J - I + wb
    in_band = (D >= 0) & (D < kb)

    data = np.zeros((nb, kb, block, block), np.float32)
    bi, bd = I[in_band], D[in_band]
    br = rows[in_band] % block
    bc = cols[in_band] % block
    data[bi, bd, br, bc] = vals[in_band].astype(np.float32)

    out_r, out_c, out_v = rows[~in_band], cols[~in_band], vals[~in_band]
    outliers = SparseCSR.from_coo(
        out_r, out_c, out_v, n, n, sr=a.sr, capacity=max(len(out_r), 1)
    )
    band = BandMatrix(jnp.asarray(data), n, block, wb, cyclic)
    return band, outliers


def band_to_coo(b: BandMatrix):
    """Host-side BandMatrix -> COO (rows, cols, vals float->uint64)."""
    data = np.asarray(jax.device_get(b.data))
    nb, kb, B, _ = data.shape
    I, D, r, c = np.nonzero(data)
    J = I + D - b.half_width_blocks
    if b.cyclic:
        J = np.mod(J, nb)
    rows = I * B + r
    cols = J * B + c
    keep = (rows < b.n) & (cols < b.n) & (J >= 0) & (J < nb)
    return rows[keep], cols[keep], data[I, D, r, c][keep]


def _to_limbs(x: jnp.ndarray, limbs: int):
    """f32 integer-valued array -> list of bf16 planes of 8-bit limbs.

    Each limb plane is <= the original value, so any partial product sum is
    bounded by the true result — partial matmuls stay exact in f32
    accumulation whenever the true result is < 2^24.
    """
    out = []
    rest = x
    for l in range(limbs):
        if l + 1 == limbs:
            limb = rest
        else:
            hi = jnp.floor(rest / 256.0)
            limb = rest - hi * 256.0
            rest = hi
        out.append(limb.astype(jnp.bfloat16))
    return out


@partial(jax.jit, static_argnames=("cyclic", "p_limbs", "a_limbs"))
def _band_matmul_data(p_data, a_data, wbp: int, wba: int, cyclic: bool,
                      p_limbs: int = 0, a_limbs: int = 0, row_offset=0):
    """Band block-diagonal convolution.  p_limbs/a_limbs == 0 -> exact f32
    matmuls (HIGHEST precision); otherwise 8-bit bf16 limb decomposition
    at the bf16 matmul rate, f32 accumulation and recombination.

    ``row_offset`` shifts the global block-row index of p_data's rows —
    the row-sharded path (dist/band.py) passes each shard's base block-row
    so the diagonal gather indexes the replicated A correctly.  A's leading
    axis is always the *global* block count."""
    nb_loc, kbp, B, _ = p_data.shape
    nb = a_data.shape[0]
    kba = a_data.shape[1]
    kbc = kbp + kba - 1
    c = jnp.zeros((nb_loc, kbc, B, B), jnp.float32)
    # tie the loop carry's device-varying status to row_offset so shard_map
    # (dist/band.py) sees matching carry types; folds away single-device
    c = c + jnp.asarray(row_offset * 0, jnp.float32)
    iota = jnp.arange(nb_loc) + row_offset

    use_limbs = p_limbs > 0 and a_limbs > 0
    if use_limbs:
        a_planes = _to_limbs(a_data, a_limbs)  # list of (nb, kba, B, B) bf16
    else:
        a_planes = [a_data]

    def dp_body(dp, c):
        shift = dp - wbp
        rows = jnp.mod(iota + shift, nb) if cyclic else jnp.clip(iota + shift, 0, nb - 1)
        valid = jnp.ones((nb_loc,), bool) if cyclic else (
            (iota + shift >= 0) & (iota + shift < nb)
        )
        p_slice = jax.lax.dynamic_slice_in_dim(p_data, dp, 1, axis=1)[:, 0]
        if use_limbs:
            p_planes = _to_limbs(p_slice, p_limbs)
            prod = None
            for lp, pp in enumerate(p_planes):
                for la, ap in enumerate(a_planes):
                    a_rows = ap[rows]
                    a_rows = jnp.where(
                        valid[:, None, None, None], a_rows, jnp.bfloat16(0)
                    )
                    part = jnp.einsum(
                        "nij,ndjk->ndik", pp, a_rows,
                        preferred_element_type=jnp.float32,
                    ) * float(1 << (8 * (lp + la)))
                    prod = part if prod is None else prod + part
        else:
            a_rows = a_data[rows]
            a_rows = jnp.where(valid[:, None, None, None], a_rows, 0.0)
            prod = jnp.einsum(
                "nij,ndjk->ndik", p_slice, a_rows,
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
        return jax.lax.dynamic_update_slice_in_dim(
            c,
            jax.lax.dynamic_slice_in_dim(c, dp, kba, axis=1) + prod,
            dp,
            axis=1,
        )

    return jax.lax.fori_loop(0, kbp, dp_body, c)


def limbs_for_max(vmax: float) -> int:
    """Number of 8-bit limbs needed to represent integer values <= vmax."""
    v = max(int(vmax), 1)
    return max(1, -(-v.bit_length() // 8))


def band_matmul(p: BandMatrix, a: BandMatrix, p_limbs: int = 0,
                a_limbs: int = 0) -> BandMatrix:
    """C = P x A for two block-band matrices (same block size & wrap mode).

    With ``p_limbs``/``a_limbs`` > 0 the inputs are decomposed into 8-bit
    bf16 limb planes and multiplied at the bf16 matmul rate (exact while true
    result values stay < 2^24 — the caller guards via max_value())."""
    assert p.block == a.block and p.cyclic == a.cyclic and p.n == a.n
    c_data = _band_matmul_data(
        p.data, a.data, p.half_width_blocks, a.half_width_blocks, p.cyclic,
        p_limbs=p_limbs, a_limbs=a_limbs,
    )
    wbc = p.half_width_blocks + a.half_width_blocks
    if p.cyclic and c_data.shape[1] > p.nb:
        return BandMatrix(fold_cyclic(c_data, wbc, p.nb), p.n, p.block, 0, True)
    return BandMatrix(c_data, p.n, p.block, wbc, p.cyclic)


def fold_cyclic(c_data: jnp.ndarray, wbc: int, nb: int) -> jnp.ndarray:
    """Band wider than the matrix: diagonals alias under the cyclic wrap.
    Fold them: slot s = (d - wbc) mod nb, re-anchored at Wb = 0 (a full
    block-circulant; duplicate slots accumulate).  Purely local along the
    diagonal axis — no cross-block-row movement."""
    kbc = c_data.shape[1]
    slot = np.mod(np.arange(kbc) - wbc, nb)
    folded = jnp.zeros((c_data.shape[0], nb) + c_data.shape[2:], jnp.float32)
    return folded.at[:, slot].add(c_data)


def band_to_csr(b: BandMatrix, sr: Semiring = U64,
                capacity: Optional[int] = None) -> SparseCSR:
    """Host-side conversion (tests / final extraction)."""
    rows, cols, vals = band_to_coo(b)
    v = np.round(vals).astype(np.uint64) if sr.name != "f32" else vals
    return SparseCSR.from_coo(
        rows, cols, v, b.n, b.n, sr=sr, capacity=capacity or max(len(rows), 1)
    )
