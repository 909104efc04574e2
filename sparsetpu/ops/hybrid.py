"""Categorized SpGEMM: dense block-band path + ESC outlier path.

The accelerator analog of MAGNUS row categorization (reference
src/graph_magnus.rs + arXiv:2501.07056): instead of categorizing rows by
accumulator locality, entries are categorized by *band membership* —
in-band entries take the dense block-band kernel (kernels/bandmm.py),
out-of-band "outlier" entries take the sort-based ESC kernel, and the
linear decomposition  (Pb + Po) x A = Pb@A + Po@A  makes the merge exact.

For the Moore-torus chain (the headline benchmark) the matrix is perfectly
cyclic-banded, so the outlier set is empty and every step is dense block
matmuls.
General graphs get banded via RCM first (graphs/algos.rcm); entries RCM
cannot compress into the band flow through ESC.

Exactness: the band path carries integer counts in f32, exact while values
stay < 2^24 (checked; overflow falls back to the exact ESC path).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..csr import SparseCSR
from ..kernels.bandmm import BandMatrix, band_matmul, band_to_csr, csr_band_split
from ..semiring import Semiring, U64
from .spgemm import spadd, spgemm_auto

F32_EXACT_LIMIT = float(1 << 24)


@dataclasses.dataclass
class HybridMatrix:
    """band + outliers decomposition of one matrix (values add)."""

    band: BandMatrix
    outliers: SparseCSR

    @property
    def n(self) -> int:
        return self.band.n

    def nnz(self) -> int:
        # band and outlier supports are disjoint by construction at split
        # time; after a matmul they may overlap, so this is an upper bound
        # unless extracted via to_csr.
        return int(self.band.nnz()) + int(self.outliers.nnz)

    def to_csr(self, sr: Semiring = U64) -> SparseCSR:
        bc = band_to_csr(self.band, sr=sr)
        if int(self.outliers.nnz) == 0:
            return bc
        cap = bc.capacity + self.outliers.capacity
        return spadd(
            bc.with_capacity(cap), self.outliers.with_capacity(cap), out_cap=cap
        ).check()


def hybrid_from_csr(a: SparseCSR, half_width: int, block: int = 128,
                    cyclic: bool = False) -> HybridMatrix:
    vmax = _csr_max_value(a)
    if vmax >= F32_EXACT_LIMIT:
        raise ValueError(
            f"band path requires values < 2^24 (got {vmax}); use ESC"
        )
    band, outliers = csr_band_split(a, half_width, block, cyclic)
    return HybridMatrix(band, outliers)


def _csr_max_value(a: SparseCSR) -> float:
    nnz = int(a.nnz)
    if nnz == 0:
        return 0.0
    _, _, vals = a.to_numpy()
    return float(vals.max()) if len(vals) else 0.0


def _band_times_sparse(p: BandMatrix, a_out: SparseCSR) -> SparseCSR:
    """C2 = P_band x A_out via column gathers: for each outlier entry
    (k, j, v), gather band column k of P (the blocks on column-block k's
    diagonal set) and scatter the scaled column as COO entries."""
    if int(a_out.nnz) == 0:
        return a_out  # empty with right shape
    B = p.block
    nb = p.nb
    kbp = p.k_blocks
    wbp = p.half_width_blocks
    cap_o = a_out.capacity

    valid = jnp.arange(cap_o) < a_out.nnz
    k = jnp.where(valid, a_out.row_of_slot(), 0)
    j = jnp.where(valid, a_out.col_idx, 0)
    v = a_out.values[0]  # f32 carried in limb 0 for the band path

    jk = k // B
    ck = k % B
    d = jnp.arange(kbp)
    I = jk[:, None] + wbp - d[None, :]  # (cap_o, kbp)
    if p.cyclic:
        I_idx = jnp.mod(I, nb)
        blk_valid = jnp.ones_like(I, bool)
    else:
        I_idx = jnp.clip(I, 0, nb - 1)
        blk_valid = (I >= 0) & (I < nb)
    # gather P.data[I, d, :, ck] -> (cap_o, kbp, B)
    colP = p.data[I_idx, d[None, :], :, ck[:, None]]
    contrib = colP * v[:, None, None]
    contrib = jnp.where(blk_valid[:, :, None] & valid[:, None, None], contrib, 0.0)
    rows = (I_idx * B)[:, :, None] + jnp.arange(B)[None, None, :]
    cols = jnp.broadcast_to(j[:, None, None], rows.shape)
    keep = (contrib != 0) & (rows < p.n)
    flat_r = rows.reshape(-1)
    flat_c = cols.reshape(-1)
    flat_v = contrib.reshape(-1)
    out_cap = max(int(np.prod(contrib.shape)), 1)
    return SparseCSR.from_coo_device(
        flat_r, flat_c, (flat_v,), p.n, p.n, a_out.sr, out_cap,
        valid=keep.reshape(-1),
    )


def hybrid_matmul(p: HybridMatrix, a: HybridMatrix,
                  a_csr: Optional[SparseCSR] = None) -> HybridMatrix:
    """C = (Pb + Po) x A = Pb@Ab [dense band] + Pb@Ao [column gather]
    + Po@A [ESC].  ``a_csr`` is the full right operand in CSR form (needed
    only when P has outliers; the chain keeps the static base matrix's CSR
    around)."""
    c_band = band_matmul(p.band, a.band)
    mx = float(jax.device_get(c_band.max_value()))
    if mx >= F32_EXACT_LIMIT - 8:
        raise OverflowError(
            "band matmul result reached the f32 exact-integer limit (2^24); "
            "use the ESC path for this product"
        )
    sr = p.outliers.sr
    parts = []
    if int(a.outliers.nnz) > 0:
        # Pb @ Ao — outliers carried on the f32 semiring limb
        ao_f32 = _as_f32_csr(a.outliers)
        c2 = _band_times_sparse(p.band, ao_f32)
        parts.append(_f32_to_sr_csr(c2, sr))
    if int(p.outliers.nnz) > 0:
        assert a_csr is not None, "need full right operand CSR for P-outliers"
        parts.append(spgemm_auto(p.outliers, a_csr))
    out = SparseCSR.empty(p.n, p.n, 1, sr)
    for part in parts:
        cap = out.capacity + part.capacity
        out = spadd(out.with_capacity(cap), part.with_capacity(cap),
                    out_cap=cap).check()
    return HybridMatrix(c_band, out)


def _as_f32_csr(a: SparseCSR) -> SparseCSR:
    from ..semiring import F32SR

    if a.sr.name == "f32":
        return a
    vals = a.sr.to_numpy(a.values).astype(np.float32)
    if float(vals.max(initial=0.0)) >= F32_EXACT_LIMIT:
        raise OverflowError("outlier values exceed f32 exact-integer range")
    return SparseCSR(
        row_ptr=a.row_ptr,
        col_idx=a.col_idx,
        values=(jnp.asarray(vals),),
        nnz=a.nnz,
        n_rows=a.n_rows,
        n_cols=a.n_cols,
        sr_name="f32",
    )


def _f32_to_sr_csr(a: SparseCSR, sr: Semiring) -> SparseCSR:
    if sr.name == "f32":
        return a
    vals = np.round(np.asarray(jax.device_get(a.values[0]))).astype(np.uint64)
    return SparseCSR(
        row_ptr=a.row_ptr,
        col_idx=a.col_idx,
        values=sr.from_numpy(vals),
        nnz=a.nnz,
        n_rows=a.n_rows,
        n_cols=a.n_cols,
        sr_name=sr.name,
    )


def choose_strategy(a: SparseCSR, steps: int = 1) -> str:
    """Pick the SpGEMM kernel category for C = A^(steps+1) chains.

    The role of the reference's MagnusConfig::default() heuristics
    (src/graph_magnus.rs:225-242): inspect the matrix and route to

      - "band":  (cyclic-)banded support and small values — block-band dense
                 kernel, zero sparse overhead (Moore tori; RCM'd meshes);
      - "dense-acc": product densifies (band covers much of the matrix
                 within `steps` squarings/products) — the row-streaming
                 dense-accumulator kernel (kernels/spmm_pallas.py);
      - "esc":   everything else (general sparsity, exact u64 needed at
                 full range) — the sort-based ESC kernel.
    """
    from ..kernels.bandmm import cyclic_bandwidth

    n = a.n_rows
    nnz = int(a.nnz)
    if nnz == 0 or n == 0:
        return "esc"
    vmax = _csr_max_value(a)
    if vmax >= F32_EXACT_LIMIT:
        return "esc"
    # dense-acc: the row-streaming kernel iterates the STATIC operand's
    # entries and keeps the product dense — chosen whenever the dense
    # product fits the memory budget and the expected final row degree
    # (deg^(steps+1)) reaches ~1% of n (the 30^3 headline chain: 3^7 =
    # 2187 of 27000 = 8%).  Bandedness is irrelevant to this path.  The 4 GB
    # and 1% thresholds await a re-fit from H100 ledger lines (ROADMAP B4).
    deg = max(nnz / max(n, 1), 1.0)
    exp_row_deg = min(deg ** (steps + 1), float(n))
    padded_cols = -(-n // 1024) * 1024
    dense_bytes = n * padded_cols * 4
    if dense_bytes <= 4e9 and exp_row_deg >= 0.01 * n:
        return "dense-acc"
    # banded and staying banded: the dense band kernel wins when the band is
    # reasonably occupied (dense blocks not mostly zeros)
    bw = cyclic_bandwidth(a)
    band_frac = 2.0 * bw / max(n, 1)
    band_density = nnz / max(band_frac * n * n, 1.0)
    if band_density > 0.01:
        return "band"
    # general scattered sparsity: the row-categorized batched kernel
    # (spgemm_auto routes "esc" to it above the small-size cutoff)
    return "esc"
