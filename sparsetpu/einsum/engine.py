"""Runtime einsum engine over mixed dense/sparse semiring operands.

The reference builds five engine generations (interpreter, sparse-driven,
bytecode VM v1/v2, Cranelift JIT — SURVEY.md L3); here ``jax.jit`` *is*
the shape-specializing JIT, so this engine is a **planner**: it classifies
the spec + operand kinds and lowers to the best available kernel:

  tier 1: sparse matmul patterns -> ESC SpGEMM / SpMM kernels (O(flops)),
          the analog of the VM's SparseRowLoop scheduling
          (linalg/src/einsum.rs:327-389).
  tier 2: all-dense f32 -> jnp.einsum (a GEMM at HIGHEST precision).
  tier 3: general fallback -> densified loop-nest contraction with exact
          semiring arithmetic (the interpreter-oracle role,
          einsum-dyn/src/lib.rs:456-474), with a joint-space size guard —
          the analog of JitError::Unsupported falling back to the VM
          (linalg/src/jit.rs:50-57).

Operands: jnp arrays / numpy (dense; f32 arrays or semiring limb tuples) or
``SparseCSR`` (2-D sparse).  Outputs are dense limb tuples (single arrays
for 1-limb semirings) per output spec.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..csr import SparseCSR
from ..ops.spgemm import spgemm, symbolic_flops
from ..semiring import F32SR, Semiring, Value
from .parser import EinsumSpec, InvalidSpec, parse_spec, validate_dims

Operand = Union[jnp.ndarray, np.ndarray, tuple, SparseCSR]

# joint-index-space guard for the general fallback (elements)
FALLBACK_MAX_ELEMS = 1 << 22


def _pow2(x: int) -> int:
    return 1 << (max(int(x), 1) - 1).bit_length()


def _operand_info(op: Operand, sr: Semiring):
    """Returns (kind, shape, limbs) with kind in {dense, sparse, grouped}."""
    from ..grouped import GroupedCSR

    if isinstance(op, GroupedCSR):
        return "grouped", op.shape, None
    if isinstance(op, SparseCSR):
        return "sparse", op.shape, None
    if isinstance(op, tuple):
        return "dense", tuple(op[0].shape), tuple(jnp.asarray(l) for l in op)
    arr = jnp.asarray(op)
    if sr.nlimbs == 1:
        return "dense", tuple(arr.shape), (arr.astype(sr.dtype),)
    raise TypeError(
        f"dense operand for {sr.name} must be a {sr.nlimbs}-limb tuple"
    )


def einsum(spec: str, operands: Sequence[Operand], sr: Semiring = F32SR,
           out_caps: Optional[Sequence[int]] = None,
           out_format: str = "dense"):
    """Evaluate `spec` over `operands` on semiring `sr`.

    ``out_format="dense"`` (default) returns dense outputs (a single array
    for 1-limb semirings, else a limb tuple).  ``out_format="sparse"``
    returns a :class:`SparseCSR` per 2-D output — when the plan lowers to
    sparse kernels the result never densifies (the reference VM keeps
    sparse structure through SparseRowLoops, linalg/src/einsum.rs:591-626;
    here the analog is carrying CSR through the pairwise-SpGEMM chain).
    """
    if out_format not in ("dense", "sparse"):
        raise ValueError(f"out_format must be dense|sparse, got {out_format}")
    parsed = parse_spec(spec)
    infos = [_operand_info(op, sr) for op in operands]
    shapes = [i[1] for i in infos]
    dims = validate_dims(parsed, shapes)

    # single-pass multi-output: outputs that are axis permutations of an
    # already-computed output reuse its contraction (the reference VM
    # emits "ab,bc->ac,ca" from one walk, linalg/src/einsum.rs:719-727;
    # here the one walk is one kernel dispatch, and the sibling output is
    # a transpose — cheap relative to recomputing the contraction)
    results: List = [None] * len(parsed.outputs)
    computed: List[Tuple[Tuple[str, ...], object]] = []
    for oi, out in enumerate(parsed.outputs):
        reused = None
        if len(set(out)) == len(out):
            for prev_out, prev_res in computed:
                if prev_out == out:
                    reused = prev_res
                    break
                if (len(set(prev_out)) == len(prev_out)
                        and set(prev_out) == set(out)):
                    reused = _permute_result(
                        prev_res, prev_out, out, sr, out_format)
                    break
        if reused is not None:
            results[oi] = reused
            continue
        res = _einsum_single(parsed, out, operands, infos, dims, sr,
                             out_format)
        computed.append((out, res))
        results[oi] = res
    return results


def _permute_result(res, src: Tuple[str, ...], dst: Tuple[str, ...],
                    sr: Semiring, out_format: str):
    """Reorder a computed output's axes from ``src`` letter order to the
    permutation ``dst``."""
    perm = tuple(src.index(ch) for ch in dst)
    if out_format == "sparse":
        assert len(src) == 2 and perm == (1, 0), (src, dst)
        return _transpose_jit(res)
    limbs = res if isinstance(res, tuple) else (res,)
    limbs = tuple(jnp.transpose(l, perm) for l in limbs)
    return limbs if isinstance(res, tuple) else limbs[0]


def _einsum_single(parsed: EinsumSpec, out: Tuple[str, ...], operands, infos,
                   dims: Dict[str, int], sr: Semiring, out_format: str):
    lowered = _try_grouped_matmul(parsed, out, operands, infos, dims, sr)
    if lowered is not None:
        return lowered
    lowered = _try_spmm(parsed, out, operands, infos, dims, sr, out_format)
    if lowered is not None:
        return lowered
    lowered = _try_sparse_chain(parsed, out, operands, infos, dims, sr,
                                out_format)
    if lowered is not None:
        return lowered
    lowered = _try_entry_driven(parsed, out, operands, infos, dims, sr,
                                out_format)
    if lowered is not None:
        return lowered
    if sr.name == "f32" and all(i[0] == "dense" for i in infos):
        arrs = [i[2][0] for i in infos]
        sub = ",".join("".join(i) for i in parsed.inputs) + "->" + "".join(out)
        dense = _dense_exec(sub, *arrs)
        return _pack_output(dense if sr.nlimbs == 1 else (dense,), out, dims,
                            sr, out_format)
    dense = _fallback_loop_nest(parsed, out, operands, infos, dims, sr)
    return _pack_output(dense, out, dims, sr, out_format)


@partial(jax.jit, static_argnames=("sub",))
def _dense_exec(sub: str, *arrs):
    """All-dense einsum as one cached compiled dispatch.  HIGHEST keeps
    full f32 products: a GPU may otherwise run an f32 matmul in TF32."""
    return jnp.einsum(sub, *(a.astype(jnp.float32) for a in arrs),
                      precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=jnp.float32)


def _pack_output(dense, out, dims, sr: Semiring, out_format: str):
    """Convert a dense result to the requested output format."""
    if out_format == "dense":
        return dense
    if len(out) != 2:
        raise InvalidSpec(
            "Unsupported",
            f"sparse output requires a 2-D output, got {len(out)} axes",
        )
    limbs = dense if isinstance(dense, tuple) else (dense,)
    # device-side pack: one scalar nnz sync, no host densify round-trip
    return SparseCSR.from_dense_device(limbs, sr)


# ---------------------------------------------------------------------------
# tier 0.5: sparse x dense matmul / matvec -> SpMM kernel (dense result)
# ---------------------------------------------------------------------------

def _try_spmm(parsed, out, operands, infos, dims, sr, out_format: str):
    """2-operand sparse x dense contraction patterns lowered to the SpMM
    gather/segment-sum kernel (ops/spmm.py): ``ab,bc->ac``, ``ab,cb->ac``,
    ``ba,bc->ac``, SpMV ``ab,b->a`` / ``b,ab->a`` and transposed variants —
    the reference VM's SparseRowLoop-over-one-sparse-operand schedule
    (linalg/src/einsum.rs:591-626).  f32 rides the float SpMM; integer
    semirings ride the exact plane-sum SpMM (ops/spmm.spmm_csr_dense_exact
    — the reference VM handles integer semirings uniformly,
    linalg/src/einsum.rs:38-85).  The dense operand never round-trips
    through the host."""
    if len(parsed.inputs) != 2:
        return None
    kinds = [infos[0][0], infos[1][0]]
    if sorted(kinds) != ["dense", "sparse"]:
        return None
    si = kinds.index("sparse")
    di = 1 - si
    s_ix, d_ix = parsed.inputs[si], parsed.inputs[di]
    if len(s_ix) != 2 or len(set(s_ix)) != 2:
        return None
    if len(d_ix) not in (1, 2) or len(set(d_ix)) != len(d_ix):
        return None
    shared = set(s_ix) & set(d_ix)
    if len(shared) != 1:
        return None
    k = shared.pop()
    if k in out:
        return None
    s_free = s_ix[0] if s_ix[1] == k else s_ix[1]
    d_free = None
    if len(d_ix) == 2:
        d_free = d_ix[0] if d_ix[1] == k else d_ix[1]
    expected = tuple(x for x in (s_free, d_free) if x is not None)
    if len(out) != len(expected) or set(out) != set(expected):
        return None

    s = operands[si]
    t_s = s_ix[0] == k
    t_d = len(d_ix) == 2 and d_ix[0] != k
    t_out = len(out) == 2 and out == (d_free, s_free)
    if sr.name == "f32":
        d = infos[di][2][0]
        # one fused dispatch: transposes + SpMM under a single cached jit
        # (eager per-op dispatch would pay one launch per op)
        result = _spmm_exec(s, d, t_s=t_s, t_d=t_d, t_out=t_out)
    else:
        # exact integer path: guarded by the plane-sum row-count window
        # (one scalar host sync; violations fall back to the loop nest)
        s_eff = _transpose_jit(s) if t_s else s
        if int(jax.device_get(jnp.max(s_eff.row_nnz()))) >= 0xFFFF:
            return None
        result, _ = _spmm_exact_exec(
            s_eff, infos[di][2], t_d=t_d, t_out=t_out)
        if sr.nlimbs == 1:
            result = result[0]
    return _pack_output(result, out, dims, sr, out_format)


@partial(jax.jit, static_argnames=("t_s", "t_d", "t_out"))
def _spmm_exec(s: SparseCSR, d, t_s: bool, t_d: bool, t_out: bool):
    from ..ops.spmm import spmm_csr_dense

    if t_s:  # contraction along sparse rows -> transpose (device)
        s = s.transpose()
    if t_d:  # contraction along dense cols
        d = d.T
    result = spmm_csr_dense(s, d.astype(jnp.float32))
    return result.T if t_out else result


@partial(jax.jit, static_argnames=("t_d", "t_out"))
def _spmm_exact_exec(s: SparseCSR, d_limbs, t_d: bool, t_out: bool):
    from ..ops.spmm import spmm_csr_dense_exact

    d_limbs = tuple(jnp.asarray(l) for l in d_limbs)
    if d_limbs[0].ndim == 1:
        out, ok = spmm_csr_dense_exact(
            s, tuple(l[:, None] for l in d_limbs))
        return tuple(l[:, 0] for l in out), ok
    if t_d:
        d_limbs = tuple(l.T for l in d_limbs)
    out, ok = spmm_csr_dense_exact(s, d_limbs)
    if t_out:
        out = tuple(l.T for l in out)
    return out, ok


# ---------------------------------------------------------------------------
# tier 0: batched (compound-row) sparse matmul — "bij,bjk->bik"
# ---------------------------------------------------------------------------

def _try_grouped_matmul(parsed, out, operands, infos, dims, sr):
    """Batched sparse matmul on GroupedCSR operands: the compound-row walk
    of the reference VM v2 (linalg/src/einsum.rs:209-232), lowered to one
    block-diagonal SpGEMM."""
    from ..grouped import GroupedCSR

    if len(parsed.inputs) != 2 or len(out) != 3:
        return None
    a_ix, b_ix = parsed.inputs
    if len(a_ix) != 3 or len(b_ix) != 3:
        return None
    if not (isinstance(operands[0], GroupedCSR)
            and isinstance(operands[1], GroupedCSR)):
        return None
    if a_ix[0] != b_ix[0] or a_ix[0] != out[0]:
        return None
    if a_ix[2] != b_ix[1] or (a_ix[1], b_ix[2]) != (out[1], out[2]):
        return None
    if len({a_ix[0], a_ix[1], a_ix[2], b_ix[2]}) != 4:
        return None
    c = operands[0].matmul(operands[1])
    dense = _grouped_to_dense(c)
    return dense if sr.nlimbs > 1 else dense[0]


def _grouped_to_dense(c) -> tuple:
    """GroupedCSR -> (g, n, m) dense limb tuple via an nnz-sized scatter.

    A first version materialized the block-diagonal flat product as a
    dense (g*n, g*m) matrix first — quadratic in g (attention shapes
    g=16384, h=12 would need ~154 GB).  Extracting per-group blocks
    directly from the flat CSR costs O(nnz)."""
    flat = c.flat
    g, n, m = c.g, c.n, c.m
    valid = jnp.arange(flat.capacity) < flat.nnz
    row = flat.row_of_slot()
    col = flat.col_idx
    gi = jnp.where(valid, row // n, g)  # out-of-range -> dropped
    ri = jnp.where(valid, row % n, 0)
    ci = jnp.where(valid, col - (row // n) * m, 0)
    ok = valid & (ci >= 0) & (ci < m)
    gi = jnp.where(ok, gi, g)
    outs = []
    for limb in flat.values:
        d = jnp.zeros((g, n, m), limb.dtype)
        outs.append(
            d.at[gi, ri, jnp.clip(ci, 0, m - 1)].add(
                jnp.where(ok, limb, 0), mode="drop"
            )
        )
    return tuple(outs)


# ---------------------------------------------------------------------------
# tier 1: matmul-chain planner (N >= 2 two-dimensional operands)
# ---------------------------------------------------------------------------

def _try_sparse_chain(parsed, out, operands, infos, dims, sr,
                      out_format: str = "dense"):
    """Greedy pairwise-contraction planner for matmul-shaped specs over any
    number of 2-D operands — ``ab,bc->ac``, ``ab,bc,cd->ad``,
    ``ab,bc,cd,de->ae``, transposed variants, etc.

    The reference's greedy VM scheduler picks one sparse-drivable loop at a
    time (linalg/src/einsum.rs:327-389); the analog here picks one pairwise
    SpGEMM at a time: contract any two operands sharing exactly one letter
    that appears nowhere else, keep the intermediate as CSR (never
    densified — a loop-nest fallback would densify for
    every >= 2-operand sparse spec), repeat until one operand remains.
    """
    if len(out) != 2 or len(set(out)) != 2:
        return None
    if any(len(ix) != 2 or len(set(ix)) != 2 for ix in parsed.inputs):
        return None
    if len(parsed.inputs) < 2 or not any(i[0] == "sparse" for i in infos):
        return None

    # letters: each contracted letter must appear in exactly 2 inputs and
    # not in the output; output letters in exactly 1 input
    occ: Dict[str, int] = {}
    for ix in parsed.inputs:
        for ch in ix:
            occ[ch] = occ.get(ch, 0) + 1
    for ch, cnt in occ.items():
        if ch in out and cnt != 1:
            return None
        if ch not in out and cnt != 2:
            return None
    if any(ch not in occ for ch in out):
        return None

    items = [
        [tuple(ix), op, info, None]  # letters, raw op, info, csr cache
        for ix, op, info in zip(parsed.inputs, operands, infos)
    ]

    def as_csr(item, transpose: bool) -> SparseCSR:
        if item[3] is None:
            item[3] = (
                item[1] if isinstance(item[1], SparseCSR)
                else _as_csr(item[1], item[2], sr, transpose=False)
            )
        return _transpose_jit(item[3]) if transpose else item[3]

    while len(items) > 1:
        found = None      # first contractible pair (may need transposes)
        found_free = None  # first transpose-free orientation — preferred
        for ia in range(len(items)):
            for ib in range(ia + 1, len(items)):
                shared = set(items[ia][0]) & set(items[ib][0])
                if len(shared) != 1:
                    continue
                k = next(iter(shared))
                if k in out:
                    continue
                a_l, b_l = items[ia][0], items[ib][0]
                x = a_l[0] if a_l[1] == k else a_l[1]
                y = b_l[0] if b_l[1] == k else b_l[1]
                if x == y:
                    continue
                # orient the pair so the shared letter is lhs-col/rhs-row
                # (transposes are full COO re-sorts — avoid when possible)
                if a_l[1] == k and b_l[0] == k:
                    found_free = (ia, ib, k, x, y)   # a @ b as-is
                elif b_l[1] == k and a_l[0] == k:
                    found_free = (ib, ia, k, y, x)   # b @ a as-is
                elif found is None:
                    found = (ia, ib, k, x, y)        # needs transpose(s)
                if found_free:
                    break
            if found_free:
                break
        found = found_free or found
        if not found:
            return None
        ia, ib, k, x, y = found
        a = as_csr(items[ia], transpose=items[ia][0][0] == k)
        b = as_csr(items[ib], transpose=items[ib][0][1] == k)
        from ..ops.spgemm import spgemm_auto

        c = spgemm_auto(a, b)  # self-routes esc vs row-categorized
        new_item = [(x, y), c, ("sparse", c.shape, None), c]
        items = [it for j, it in enumerate(items) if j not in (ia, ib)]
        items.append(new_item)

    letters = items[0][0]
    c = as_csr(items[0], transpose=False)
    if letters == tuple(out)[::-1]:
        c = _transpose_jit(c)
    elif letters != tuple(out):
        return None
    if out_format == "sparse":
        return c
    dense = c.to_dense()
    return dense if sr.nlimbs > 1 else dense[0]


_transpose_jit = jax.jit(lambda s: s.transpose())


def _as_csr(op, info, sr: Semiring, transpose: bool) -> SparseCSR:
    if isinstance(op, SparseCSR):
        return op.transpose() if transpose else op
    limbs = info[2]
    if transpose:
        limbs = tuple(l.T for l in limbs)
    # device-side sparsify (one scalar nnz sync for the static capacity)
    return SparseCSR.from_dense_device(limbs, sr)


# ---------------------------------------------------------------------------
# tier 2: entry-driven lowering — ANY spec with exactly one sparse operand
# ---------------------------------------------------------------------------

# joint guard for the entry-driven tier: cap x (unbound dense letter space)
ENTRY_DRIVEN_MAX_ELEMS = 1 << 26


def _try_entry_driven(parsed, out, operands, infos, dims, sr,
                      out_format: str):
    """General sparse-driven schedule for specs with exactly one 2-D sparse
    operand (f32): iterate the sparse entries, evaluate the dense
    sub-contraction per entry (gathers bind the sparse letters), and
    scatter-accumulate into the output — the analog of the reference
    VM's SparseRowLoop driving an arbitrary inner loop nest
    (linalg/src/einsum.rs:591-626).  Covers sparse traces (``aa->``),
    row/col reductions (``ab->a``), elementwise masks (``ab,ab->ab``),
    N-D dense partners (``ab,bcd->acd``), and free-sparse-letter products
    (``ab,ac->abc``).  Additional sparse operands join the schedule when
    ALL their letters are bound by the driving operand (``ab,ab->``,
    ``ab,ba->``, sparse-sparse masks): each is read by an O(log nnz)
    per-entry coordinate ``lookup`` — the VM's sparse-value cache role
    (einsum-dyn/src/sparse.rs:392-406).  A 3-D GroupedCSR may drive too:
    its flat block-diagonal entry stream binds the (batch, row, col)
    letters — the VM v2 compound-row walk (linalg/src/einsum.rs:209-232)
    — covering batched specs like ``bij,jk->bik`` and ``bij->bi``.

    Integer semirings take this tier too when every operand is sparse
    (traces, reductions, masks — ``ab,ab->``, ``ab->a``, ``aa->``):
    products fold on the exact saturating semiring and outputs accumulate
    as 16-bit plane sums (the reference VM's uniform integer handling,
    linalg/src/einsum.rs:38-85).  Integer specs with dense partners would
    need exact per-entry sub-contractions the f32 vmap cannot give —
    those stay with the loop-nest fallback."""
    from ..grouped import GroupedCSR

    sparse_pos = [i for i, inf in enumerate(infos)
                  if inf[0] in ("sparse", "grouped")]
    if not sparse_pos:
        return None
    if sr.name != "f32" and len(sparse_pos) != len(infos):
        return None
    si = sparse_pos[0]
    s_ix = parsed.inputs[si]
    s = operands[si]
    if isinstance(s, GroupedCSR):
        if len(s_ix) != 3 or len(set(s_ix)) != 3:
            return None
        drv = ("grouped", tuple(s_ix), s.n, s.m)
        s_flat = s.flat
        bound = set(s_ix)
    else:
        if len(s_ix) != 2:
            return None
        p, q = s_ix
        drv = ("csr", (p, q))
        s_flat = s
        bound = {p} if p == q else {p, q}

    # other sparse operands: every letter must be bound by the driver
    extra_flats: List[SparseCSR] = []
    extra = []
    for j in sparse_pos[1:]:
        ix = parsed.inputs[j]
        o = operands[j]
        if not set(ix) <= bound:
            return None
        if isinstance(o, GroupedCSR):
            if len(ix) != 3:
                return None
            extra_flats.append(o.flat)
            extra.append(("grouped", tuple(ix), o.n, o.m))
        else:
            if len(ix) != 2:
                return None
            extra_flats.append(o)
            extra.append(("csr", tuple(ix)))

    rest = set(sparse_pos)
    dense_ixs = tuple(
        tuple(ix) for j, ix in enumerate(parsed.inputs) if j not in rest
    )
    dense_arrs = [infos[j][2][0] for j in range(len(operands))
                  if j not in rest]
    # repeated letters inside a dense operand (diagonals) are out of this
    # tier's scope — leave to the fallback
    if any(len(set(ix)) != len(ix) for ix in dense_ixs):
        return None

    unbound = [ch for ch in parsed.slots if ch not in bound]
    work = s_flat.capacity * int(np.prod([dims[ch] for ch in unbound]) or 1)
    if work > ENTRY_DRIVEN_MAX_ELEMS:
        return None

    if sr.name != "f32":
        result, ok = _entry_driven_exact_exec(
            s_flat, tuple(extra_flats), drv=drv, extra=tuple(extra),
            out=tuple(out), dims_t=tuple(sorted(dims.items())),
            sr_name=sr.name,
        )
        # per-cell plane window exceeded (>= 2^16 colliding entries):
        # fall back to the exact loop nest (one scalar host sync)
        if not bool(jax.device_get(ok)):
            return None
        if sr.nlimbs == 1:
            result = result[0]
        return _pack_output(result, out, dims, sr, out_format)

    result = _entry_driven_exec(
        s_flat, tuple(dense_arrs), tuple(extra_flats),
        drv=drv, dense_ixs=dense_ixs, extra=tuple(extra),
        out=tuple(out), dims_t=tuple(sorted(dims.items())),
    )
    return _pack_output(result, out, dims, sr, out_format)


@partial(jax.jit, static_argnames=("drv", "dense_ixs", "extra", "out",
                                   "dims_t"))
def _entry_driven_exec(s: SparseCSR, dense_arrs, extra_flats, drv, dense_ixs,
                       extra, out, dims_t):
    """Traced body of the entry-driven tier: one cached dispatch per
    (spec-structure, shapes) key.  ``drv``/``extra`` entries are
    ("csr", letters) or ("grouped", letters, n, m) layout descriptors
    for the flat SparseCSR pytrees."""
    dims = dict(dims_t)
    cap = s.capacity
    valid = jnp.arange(cap) < s.nnz
    r = s.row_of_slot()
    c = s.col_idx
    if drv[0] == "grouped":
        _, (lb, li, lj), n, m = drv
        b = jnp.where(valid, r // n, 0).astype(jnp.int32)
        letter_val = {
            lb: b,
            li: jnp.where(valid, r % n, 0).astype(jnp.int32),
            lj: jnp.where(valid, c - b * m, 0).astype(jnp.int32),
        }
    else:
        p, q = drv[1]
        if p == q:  # diagonal view of the sparse operand
            valid = valid & (r == c)
        letter_val = {p: jnp.where(valid, r, 0).astype(jnp.int32)}
        if p != q:
            letter_val[q] = jnp.where(valid, c, 0).astype(jnp.int32)
    v = jnp.where(valid, s.values[0].astype(jnp.float32), 0.0)
    bound = set(letter_val)
    # extra sparse operands: per-entry coordinate lookup, fold into v
    for s2, e in zip(extra_flats, extra):
        if e[0] == "grouped":
            _, (xb, xi, xj), n2, m2 = e
            (v2,) = s2.lookup(letter_val[xb] * n2 + letter_val[xi],
                              letter_val[xb] * m2 + letter_val[xj])
        else:
            ix = e[1]
            (v2,) = s2.lookup(letter_val[ix[0]], letter_val[ix[1]])
        v = v * v2.astype(jnp.float32)
    dense_arrs = tuple(a.astype(jnp.float32) for a in dense_arrs)

    out_s = tuple(ch for ch in out if ch in bound)
    out_d = tuple(ch for ch in out if ch not in bound)
    sub_out = "".join(out_d)

    if dense_arrs:
        sub_specs = ["".join(ch for ch in ix if ch not in bound)
                     for ix in dense_ixs]
        sub = ",".join(sub_specs) + "->" + sub_out

        def per_entry(idx):
            sliced = []
            for ix, arr in zip(dense_ixs, dense_arrs):
                a = arr
                # bind sparse letters by scalar-indexing their axes,
                # highest axis first so positions stay valid
                for ax in sorted(
                    (k for k, ch in enumerate(ix) if ch in bound),
                    reverse=True,
                ):
                    a = jnp.take(a, idx[ix[ax]], axis=ax)
                sliced.append(a)
            return jnp.einsum(sub, *sliced,
                              precision=jax.lax.Precision.HIGHEST,
                              preferred_element_type=jnp.float32)

        contrib = jax.vmap(per_entry)(
            {ch: iv for ch, iv in letter_val.items()}
        )
        contrib = v.reshape((cap,) + (1,) * (contrib.ndim - 1)) * contrib
    else:
        contrib = v.reshape((cap,) + (1,) * len(out_d))
        contrib = jnp.broadcast_to(
            contrib, (cap,) + tuple(dims[ch] for ch in out_d))

    if out_s:
        shape0 = tuple(dims[ch] for ch in out_s + out_d)
        idxs = tuple(
            jnp.where(valid, letter_val[ch], dims[ch]) for ch in out_s
        )
        res0 = jnp.zeros(shape0, jnp.float32).at[idxs].add(
            contrib, mode="drop")
    else:
        res0 = jnp.sum(contrib, axis=0)
    # reorder (out_s ++ out_d) axes into the requested output order
    order0 = out_s + out_d
    perm = tuple(order0.index(ch) for ch in out)
    return jnp.transpose(res0, perm) if perm != tuple(
        range(len(out))) else res0


@partial(jax.jit, static_argnames=("drv", "extra", "out", "dims_t",
                                   "sr_name"))
def _entry_driven_exact_exec(s: SparseCSR, extra_flats, drv, extra, out,
                             dims_t, sr_name: str):
    """Exact-integer entry-driven tier (no dense operands): per-entry
    semiring products fold via vectorized saturating ops; outputs
    accumulate as 16-bit plane sums recombined with saturation
    (segments._recombine_sat16 — saturating fold of non-negative values ==
    min(true sum, MAX)).  Returns (limbs, exact_ok); exact while every
    output cell receives < 2^16 entries (ok=False -> caller falls back)."""
    from ..ops import segments
    from ..semiring import U32, U64

    sr = U64 if sr_name == "u64" else U32
    dims = dict(dims_t)
    cap = s.capacity
    valid = jnp.arange(cap) < s.nnz
    r = s.row_of_slot()
    c = s.col_idx
    if drv[0] == "grouped":
        _, (lb, li, lj), n, m = drv
        b = jnp.where(valid, r // n, 0).astype(jnp.int32)
        letter_val = {
            lb: b,
            li: jnp.where(valid, r % n, 0).astype(jnp.int32),
            lj: jnp.where(valid, c - b * m, 0).astype(jnp.int32),
        }
    else:
        p, q = drv[1]
        if p == q:
            valid = valid & (r == c)
        letter_val = {p: jnp.where(valid, r, 0).astype(jnp.int32)}
        if p != q:
            letter_val[q] = jnp.where(valid, c, 0).astype(jnp.int32)
    v = sr.where(valid, s.values, sr.zeros((cap,)))
    for s2, e in zip(extra_flats, extra):
        if e[0] == "grouped":
            _, (xb, xi, xj), n2, m2 = e
            v2 = s2.lookup(letter_val[xb] * n2 + letter_val[xi],
                           letter_val[xb] * m2 + letter_val[xj])
        else:
            ix = e[1]
            v2 = s2.lookup(letter_val[ix[0]], letter_val[ix[1]])
        v = sr.mul(v, v2)

    m16 = jnp.uint32(0xFFFF)
    planes = []
    for limb in v:
        planes.append(limb & m16)
        planes.append(limb >> 16)

    out_s = tuple(ch for ch in out)  # every letter is driver-bound here
    if out_s:
        shape = tuple(dims[ch] for ch in out_s)
        idxs = tuple(
            jnp.where(valid, letter_val[ch], dims[ch]) for ch in out_s
        )
        sums = [
            jnp.zeros(shape, jnp.uint32).at[idxs].add(p, mode="drop")
            for p in planes
        ]
        counts = jnp.zeros(shape, jnp.uint32).at[idxs].add(
            jnp.where(valid, jnp.uint32(1), jnp.uint32(0)), mode="drop")
        exact_ok = jnp.max(counts) < 0xFFFF
        return segments._recombine_sat16(sr, sums), exact_ok

    # scalar output: exact per-chunk plane sums (chunk <= 2^15 terms keeps
    # a uint32 plane sum exact), then a saturating fold over chunk totals
    L = 1 << 15
    nb = -(-cap // L)
    pad = nb * L - cap

    def chunk_limbs(pl):
        p2 = jnp.concatenate([pl, jnp.zeros((pad,), jnp.uint32)])
        return jnp.sum(p2.reshape(nb, L), axis=1, dtype=jnp.uint32)

    per_chunk = segments._recombine_sat16(
        sr, [chunk_limbs(p) for p in planes])

    def body(i, acc):
        return sr.add(acc, tuple(l[i] for l in per_chunk))

    total = jax.lax.fori_loop(
        1, nb, body, tuple(l[0] for l in per_chunk))
    return total, jnp.asarray(True)


# ---------------------------------------------------------------------------
# tier 3: general loop-nest fallback (exact, any semiring, any spec)
# ---------------------------------------------------------------------------

def _densify(op, info, sr: Semiring):
    from ..grouped import GroupedCSR

    if isinstance(op, GroupedCSR):
        return _grouped_to_dense(op)
    if isinstance(op, SparseCSR):
        return op.to_dense()
    return info[2]


def _fallback_loop_nest(parsed, out, operands, infos, dims, sr: Semiring):
    """Broadcast every operand into the joint index space (free ++ contracted),
    multiply on the semiring, then reduce contracted axes with saturating adds."""
    letters = list(out) + [s for s in parsed.slots if s not in out]
    joint_shape = tuple(dims[ch] for ch in letters)
    n_elems = int(np.prod(joint_shape)) if joint_shape else 1
    if n_elems > FALLBACK_MAX_ELEMS:
        raise InvalidSpec(
            "Unsupported",
            f"no kernel for spec {parsed.canonical()!r} and joint space "
            f"{n_elems} exceeds the fallback guard",
        )

    prod: Optional[Value] = None
    for op, info, inp in zip(operands, infos, parsed.inputs):
        limbs = _densify(op, info, sr)
        expanded = _broadcast_to_joint(limbs, inp, letters, dims)
        prod = expanded if prod is None else sr.mul(prod, expanded)

    # reduce contracted axes (sequential saturating fold along flattened axis)
    n_free = len(out)
    contracted_size = int(np.prod(joint_shape[n_free:])) if letters[n_free:] else 1
    free_shape = joint_shape[:n_free]
    flat = tuple(l.reshape(free_shape + (contracted_size,)) for l in prod)
    if contracted_size == 1:
        total = tuple(l[..., 0] for l in flat)
    else:
        def body(i, acc):
            cur = tuple(l[..., i] for l in flat)
            return sr.add(acc, cur)

        init = tuple(l[..., 0] for l in flat)
        total = jax.lax.fori_loop(1, contracted_size, body, init)
    return total if sr.nlimbs > 1 else total[0]


def _broadcast_to_joint(limbs: Value, inp: Tuple[str, ...], letters: List[str],
                        dims: Dict[str, int]) -> Value:
    """Extract diagonals for repeated letters, then broadcast to the joint space."""
    uniq: List[str] = []
    for ch in inp:
        if ch not in uniq:
            uniq.append(ch)
    if len(uniq) != len(inp):
        # take diagonals: index each axis by the unique-letter index grids
        grids = jnp.meshgrid(
            *[jnp.arange(dims[ch]) for ch in uniq], indexing="ij"
        ) if uniq else []
        index = tuple(grids[uniq.index(ch)] for ch in inp)
        limbs = tuple(l[index] for l in limbs)
    # now limbs has axes = uniq; move into joint layout
    perm_src = [letters.index(ch) for ch in uniq]
    out = []
    for l in limbs:
        shape = [1] * len(letters)
        for ax, ch in enumerate(uniq):
            shape[letters.index(ch)] = dims[ch]
        lr = l.reshape([dims[ch] for ch in uniq]) if uniq else l
        # permute uniq axes into ascending joint positions
        order = np.argsort(perm_src)
        lr = jnp.transpose(lr, tuple(order)) if len(uniq) > 1 else lr
        out.append(jnp.broadcast_to(lr.reshape(shape), [dims[ch] for ch in letters]))
    return tuple(out)
