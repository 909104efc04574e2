"""The A^2..A^7 repeated-exponentiation chain benchmark (the north star).

Reference: bench_repeated_exponentiation (src/graph_magnus.rs:700-788) —
30x30x30 Moore torus, thinned to ~3 edges/node, chain of C_k = C_{k-1} x A
with nnz growing 252k -> 11.7M, 3-iteration timed averages and nnz-agreement
asserts, CSV rows per step.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..csr import SparseCSR
from ..ops.spgemm import spgemm, symbolic_flops
from ..semiring import U64, Semiring
from ..graphs import generate


def _pow2(x: int) -> int:
    return 1 << (max(int(x), 1) - 1).bit_length()


@dataclass
class ChainStep:
    step: int
    nnz: int
    flops: int
    seconds: float
    nnz_per_s: float
    gflops: float


@dataclass
class HostCSR:
    """Pure-numpy CSR build (no jax) — produced by build_torus_host so graph
    generation AND the native-oracle chain can run in a host thread while
    the main thread initialises the device and compiles (see bench.py)."""
    row_ptr: np.ndarray
    col_idx: np.ndarray
    limbs: list
    nnz: int
    n: int
    sr: Semiring

    def vals_u64(self) -> np.ndarray:
        lo = self.limbs[0][: self.nnz].astype(np.uint64)
        if len(self.limbs) > 1:
            lo = lo | (self.limbs[1][: self.nnz].astype(np.uint64) << np.uint64(32))
        return lo

    def to_device(self) -> SparseCSR:
        return SparseCSR.from_host_arrays(
            self.row_ptr, self.col_idx, self.limbs, self.nnz,
            self.n, self.n, self.sr,
        )


def build_torus_host(dims: Sequence[int] = (30, 30, 30),
                     density: float = 3.0 / 26.0, seed: int = 42,
                     sr: Semiring = U64) -> HostCSR:
    coo = generate.lattice(list(dims), torus=True)
    if density < 1.0:
        coo = generate.thin(coo, density, seed=seed)
    rows, cols, vals, n = coo
    row_ptr, col_idx, limbs, nnz = SparseCSR.host_csr_arrays(
        rows, cols, vals, n, n, sr, capacity=_pow2(len(rows))
    )
    return HostCSR(row_ptr, col_idx, limbs, nnz, n, sr)


def build_torus(dims: Sequence[int] = (30, 30, 30), density: float = 3.0 / 26.0,
                seed: int = 42, sr: Semiring = U64) -> SparseCSR:
    # host-side build: graph generation is host-side anyway, so the CSR is
    # assembled there and copied once
    return build_torus_host(dims, density, seed, sr).to_device()


def run_chain(
    a: SparseCSR,
    max_step: int = 7,
    iters: int = 3,
    verbose: bool = True,
) -> List[ChainStep]:
    """Time C_k = C_{k-1} x A for k = 2..max_step on the current backend.

    Each step: host fetches the symbolic flop count (pow2-bucketed capacity),
    then times the jitted numeric ESC kernel with block_until_ready.
    """
    results: List[ChainStep] = []
    prev = a
    for step in range(2, max_step + 1):
        flops = int(symbolic_flops(prev, a))
        cap = _pow2(flops)
        # compile + warmup (also produces the result we carry forward)
        c = spgemm(prev, a, cap)
        jax.block_until_ready(c.nnz)
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            out = spgemm(prev, a, cap)
            jax.block_until_ready(out.nnz)
            times.append(time.perf_counter() - t0)
        dt = min(times)
        nnz = int(c.nnz)
        rec = ChainStep(
            step=step,
            nnz=nnz,
            flops=flops,
            seconds=dt,
            nnz_per_s=nnz / dt,
            gflops=2.0 * flops / dt / 1e9,
        )
        results.append(rec)
        if verbose:
            print(
                f"A^{step}: nnz={nnz} flops={flops} time={dt*1e3:.2f}ms "
                f"nnz/s={rec.nnz_per_s/1e6:.1f}M gflops={rec.gflops:.2f}",
                flush=True,
            )
        prev = c
    return results


def run_chain_band(
    a: SparseCSR,
    half_width: int,
    block: int = 125,
    max_step: int = 7,
    iters: int = 3,
    verbose: bool = True,
) -> List[ChainStep]:
    """Band-kernel chain: C_k = C_{k-1} x A entirely as block-band dense
    matmuls (the categorized fast path; torus matrices are cyclic-banded so
    there are no outliers).  Values are guarded < 2^24; the per-step limb
    counts come from the running max value."""
    from ..kernels import bandmm

    band_a, outliers = bandmm.csr_band_split(
        a, half_width=half_width, block=block, cyclic=True
    )
    assert int(outliers.nnz) == 0, "torus must be fully cyclic-banded"
    a_limbs = bandmm.limbs_for_max(float(jax.device_get(band_a.max_value())))

    results: List[ChainStep] = []
    prev = band_a
    for step in range(2, max_step + 1):
        pmax = float(jax.device_get(prev.max_value()))
        p_limbs = bandmm.limbs_for_max(pmax)
        run = lambda: bandmm.band_matmul(prev, band_a, p_limbs=p_limbs,
                                         a_limbs=a_limbs)
        c = run()
        jax.block_until_ready(c.data)
        cmax = float(jax.device_get(c.max_value()))
        if cmax >= float(1 << 24) - 8:
            raise OverflowError("band chain exceeded f32 exact range")
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            out = run()
            jax.block_until_ready(out.data)
            times.append(time.perf_counter() - t0)
        dt = min(times)
        nnz = int(jax.device_get(c.nnz()))
        rec = ChainStep(
            step=step, nnz=nnz, flops=0, seconds=dt,
            nnz_per_s=nnz / dt, gflops=0.0,
        )
        results.append(rec)
        if verbose:
            print(
                f"A^{step} [band,{p_limbs}x{a_limbs} limbs]: nnz={nnz} "
                f"time={dt*1e3:.2f}ms nnz/s={rec.nnz_per_s/1e6:.1f}M "
                f"max={cmax:.0f}",
                flush=True,
            )
        prev = c
    return results


def run_chain_pallas(
    a: SparseCSR,
    max_step: int = 7,
    iters: int = 3,
    verbose: bool = True,
    per_step: bool = True,
    reps: int = 4,
    keep_final: Optional[dict] = None,
) -> List[ChainStep]:
    """Dense-accumulator chain (kernels/spmm_pallas.py): the product lives
    as a dense f32 matrix and each step streams the P rows A references.

    One untimed stats pass computes every step's nnz, max and exact
    expansion flops on the device (and the final product, for value
    verification).  Every step's time is a TRUE differential
    t(chain of s) - t(chain of s-1) — the reference reports genuine per-k
    times (README.md:39-46) and so does this.  The whole chain runs as ONE
    jitted program whose ``steps``/``reps`` are traced loop bounds, so
    every prefix length reuses the same executable.  Timing inputs get a
    per-iteration bump so XLA cannot hoist a step out of the loop.
    ``reps`` whole-chain repetitions are fused into each timed program so
    the adjacent-prefix differential is reps x one step, well above the
    host clock's noise.  ``per_step=False`` times only the A^max
    differential.  ``keep_final``: pass a dict to receive the final chain
    product (column-padded) under key "p"."""
    from functools import partial as _partial

    from ..kernels import spmm_pallas as sp

    rp, ci, vals = sp.csr_operand(a)
    p0 = jax.jit(lambda m: sp.pad_cols(tuple_to_f32_dense(m)))(a)
    jax.block_until_ready(p0)
    k = max_step - 1  # number of products in the chain

    # A's per-row nnz laid out like a P row, for exact per-step flop
    # counts: flops(P x A) = sum_k colnnz(P)[k] * row_nnz_A[k]
    rnz_np = np.zeros((p0.shape[1],), np.float32)
    rnz_np[: a.n_rows] = np.diff(np.asarray(jax.device_get(a.row_ptr)))
    rnz = jnp.asarray(rnz_np)

    def _step(p):
        return sp.spmm_pallas(rp, ci, vals, p)

    @_partial(jax.jit, static_argnames=("steps",))
    def stats_chain(p, steps: int):
        maxes = jnp.zeros((steps,), jnp.float32)
        nnzs = jnp.zeros((steps,), jnp.int32)
        flops = jnp.zeros((steps,), jnp.float32)

        def body(i, carry):
            p, maxes, nnzs, flops = carry
            colnnz = jnp.sum((p != 0).astype(jnp.float32), axis=0)
            flops = flops.at[i].set(jnp.sum(colnnz * rnz))
            c = _step(p)
            maxes = maxes.at[i].set(jnp.max(c))
            nnzs = nnzs.at[i].set(jnp.count_nonzero(c).astype(jnp.int32))
            return (c, maxes, nnzs, flops)

        return jax.lax.fori_loop(0, steps, body, (p, maxes, nnzs, flops))

    @jax.jit
    def timed_chain(p0, bump, steps, reps):
        # `bump` perturbs one input element so XLA cannot hoist any step
        # out of the loop — every step's input is data-dependent on the
        # previous product.  The whole chain runs `reps` times (each rep
        # distinctly perturbed, results chained into the accumulator) so
        # the prefix differential carries reps steps.
        def rep(r, carry):
            acc, _ = carry
            p = p0.at[0, 0].add(bump + jnp.float32(r) + acc * 1e-30)
            p = jax.lax.fori_loop(0, steps, lambda i, q: _step(q), p)
            return acc + p[0, 0], p

        return jax.lax.fori_loop(0, reps, rep, (jnp.float32(0.0), p0))

    p_final, maxes, nnzs, flops = stats_chain(p0, k)
    maxes, nnzs, flops = map(np.asarray,
                             map(jax.device_get, (maxes, nnzs, flops)))
    if float(maxes.max()) >= float(1 << 24) - 8:
        raise OverflowError("dense-accumulator chain exceeded f32 exact range")
    if keep_final is not None:
        keep_final["p"] = p_final
    else:
        del p_final

    def _time(steps):
        acc, _ = timed_chain(p0, 0.0, steps, reps)  # warm (cached program)
        jax.block_until_ready(acc)
        best = float("inf")
        for it in range(iters):
            t0 = time.perf_counter()
            acc, _ = timed_chain(p0, float(it + 1), steps, reps)
            jax.block_until_ready(acc)
            best = min(best, time.perf_counter() - t0)
        return best / reps

    # per-step differentials: time chains of length s, subtract adjacent.
    # The 0-step chain measures the fixed dispatch + sync floor, so the A^2
    # differential doesn't absorb it.
    steps_to_time = list(range(k + 1)) if per_step else [k - 1, k]
    prefix = {s: _time(s) for s in steps_to_time}

    results: List[ChainStep] = []
    for idx in range(k):
        step = idx + 2
        timed = (idx in prefix) and (idx + 1 in prefix)
        dt = (max(prefix[idx + 1] - prefix[idx], 1e-9) if timed
              else float("nan"))
        nnz = int(nnzs[idx])
        fl = int(flops[idx])
        rec = ChainStep(step=step, nnz=nnz, flops=fl, seconds=dt,
                        nnz_per_s=nnz / dt if timed else float("nan"),
                        gflops=2.0 * fl / dt / 1e9 if timed else float("nan"))
        results.append(rec)
        if verbose:
            tstr = (f"time={dt*1e3:.3f}ms nnz/s={rec.nnz_per_s/1e6:.1f}M "
                    f"gflops={rec.gflops:.2f}" if timed else "untimed")
            print(
                f"A^{step} [dense-acc]: nnz={nnz} flops={fl} {tstr} "
                f"max={maxes[idx]:.0f}",
                flush=True,
            )
    return results


def run_chain_rowcat(
    a: SparseCSR,
    max_step: int = 7,
    iters: int = 3,
    verbose: bool = True,
) -> List[ChainStep]:
    """Row-categorized chain: C_k = C_{k-1} x A through ops/rowcat.py —
    the general sparse-output path (product stays CSR; the right category
    kernel per row each step)."""
    from ..ops.rowcat import spgemm_rowcat
    from ..ops.spgemm import symbolic_flops_exact

    results: List[ChainStep] = []
    prev = a
    for step in range(2, max_step + 1):
        flops = symbolic_flops_exact(prev, a)
        c = spgemm_rowcat(prev, a).check()
        jax.block_until_ready(c.nnz)
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            out = spgemm_rowcat(prev, a)
            jax.block_until_ready(out.nnz)
            times.append(time.perf_counter() - t0)
        dt = min(times)
        nnz = int(c.nnz)
        rec = ChainStep(
            step=step, nnz=nnz, flops=flops, seconds=dt,
            nnz_per_s=nnz / dt, gflops=2.0 * flops / dt / 1e9,
        )
        results.append(rec)
        if verbose:
            print(
                f"A^{step} [rowcat]: nnz={nnz} flops={flops} "
                f"time={dt*1e3:.2f}ms nnz/s={rec.nnz_per_s/1e6:.1f}M",
                flush=True,
            )
        prev = c
    return results


def run_chain_escb(
    a: SparseCSR,
    max_step: int = 7,
    iters: int = 3,
    verbose: bool = True,
) -> List[ChainStep]:
    """Blocked-ESC chain: C_k = C_{k-1} x A through ops/escb.py — the
    compile-bounded general sparse-output path (row-packed batched sort;
    see ops/escb.py).  Per-call wall time including the host plan pass
    (one n-sized fetch + bin packing), matching how a user would run it."""
    from ..ops.escb import spgemm_blocked

    results: List[ChainStep] = []
    prev = a
    for step in range(2, max_step + 1):
        c = spgemm_blocked(prev, a).check()
        jax.block_until_ready(c.nnz)
        flops = int(np.int64(0))
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            out = spgemm_blocked(prev, a)
            jax.block_until_ready(out.nnz)
            times.append(time.perf_counter() - t0)
        dt = min(times)
        from ..ops.spgemm import symbolic_flops_exact

        flops = symbolic_flops_exact(prev, a)
        nnz = int(c.nnz)
        rec = ChainStep(
            step=step, nnz=nnz, flops=flops, seconds=dt,
            nnz_per_s=nnz / dt, gflops=2.0 * flops / dt / 1e9,
        )
        results.append(rec)
        if verbose:
            print(
                f"A^{step} [escb]: nnz={nnz} flops={flops} "
                f"time={dt*1e3:.2f}ms nnz/s={rec.nnz_per_s/1e6:.1f}M",
                flush=True,
            )
        prev = c
    return results


def native_chain_stats_host(row_ptr, col_idx, vals, n: int, max_step: int = 7):
    """A^2..A^max on the native C++ oracle from host numpy CSR arrays —
    no jax involvement, so it can run in a host thread beside the device
    work."""
    from .. import native

    base = native.as_host_csr(
        np.asarray(row_ptr, np.int64), np.asarray(col_idx, np.int32),
        np.asarray(vals, np.uint64),
    )
    rnz_a = np.diff(np.asarray(row_ptr, np.int64))
    stats = []  # (step, nnz, max_value, expansion_flops)
    prev = base
    for step in range(2, max_step + 1):
        # flops of the multiply producing A^step: every entry (i,k) of the
        # current power expands to row_nnz_A[k] partial products.  col_idx
        # may be capacity-padded (sentinel cols) — gather valid entries only
        p_rp, p_cc = prev[0], prev[1]
        flops = int(rnz_a[np.asarray(p_cc[: p_rp[-1]], np.int64)].sum())
        prev = native.spgemm(prev, base, n)
        crp, cc, cv = prev
        stats.append((step, int(crp[-1]),
                      int(cv.max()) if len(cv) else 0, flops))
    return stats, prev


def native_chain_stats(a: SparseCSR, max_step: int = 7):
    """Run the A^2..A^max chain on the native C++ oracle (exact u64
    saturating semiring) and return per-step stats plus the final CSR.

    The reference's discipline is agreement-then-time
    (src/graph_magnus.rs:751-753); this provides the agreement half for the
    full measured scale (30^3, 11.7M nnz — seconds of host time), not just
    the small CPU test graphs.
    """
    row_ptr, col_idx, vals = a.to_numpy()
    return native_chain_stats_host(row_ptr, col_idx, vals, a.n_rows, max_step)


def chain_final_pallas(a: SparseCSR, max_step: int = 7):
    """One un-timed dense-accumulator chain pass; returns the final product
    P (device, column-padded) for agreement checks against the oracle."""
    from functools import partial as _partial

    from ..kernels import spmm_pallas as sp

    rp, ci, vals = sp.csr_operand(a)
    p0 = sp.pad_cols(host_f32_dense(a))

    @_partial(jax.jit, static_argnames=("steps",))
    def chain(p, steps: int):
        return jax.lax.fori_loop(
            0, steps, lambda i, q: sp.spmm_pallas(rp, ci, vals, q), p)

    return chain(p0, max_step - 1)


def verify_final_values(a: SparseCSR, native_final, max_step: int = 7,
                        sample_rows: int = 128, p=None):
    """Exact value check of the dense-accumulator chain's final product
    against a precomputed native-oracle CSR: global nnz + max, plus
    element-exact agreement on ``sample_rows`` leading rows.  ``p``: a
    precomputed final product (e.g. run_chain_pallas keep_final) avoids
    compiling another chain program."""
    crp, cc, cv = native_final
    if p is None:
        p = chain_final_pallas(a, max_step)
    dev_nnz = int(jax.device_get(jnp.count_nonzero(p)))
    dev_max = float(jax.device_get(jnp.max(p)))
    want_nnz = int(crp[-1])
    want_max = int(cv.max()) if len(cv) else 0
    if dev_nnz != want_nnz or int(dev_max) != want_max:
        raise AssertionError(
            f"chain A^{max_step}: device nnz/max {dev_nnz}/{dev_max:.0f} != "
            f"native {want_nnz}/{want_max}")
    m = min(sample_rows, a.n_rows)
    got = np.asarray(jax.device_get(p[:m, : a.n_cols]))
    want = np.zeros((m, a.n_cols), np.float64)
    for r in range(m):
        s, e = int(crp[r]), int(crp[r + 1])
        want[r, cc[s:e]] = cv[s:e].astype(np.float64)
    if not np.array_equal(got.astype(np.float64), want):
        raise AssertionError(
            "chain values disagree with the native oracle in leading rows")


def host_f32_dense(a: SparseCSR) -> np.ndarray:
    """SparseCSR (small integer values) -> dense f32 on host (no device
    round-trip; for chain P initialization)."""
    row_ptr, col_idx, vals = a.to_numpy()
    n = a.n_rows
    out = np.zeros((n, a.n_cols), np.float32)
    rows = np.repeat(np.arange(n), np.diff(row_ptr))
    out[rows, col_idx] = vals.astype(np.float32)
    return out


def tuple_to_f32_dense(a: SparseCSR):
    """SparseCSR (small integer values) -> dense f32 matrix on device."""
    dense_limbs = a.to_dense()
    f = dense_limbs[0].astype(jnp.float32)
    if len(dense_limbs) > 1:
        f = f + dense_limbs[1].astype(jnp.float32) * float(1 << 32)
    return f


def chain_csv(results: List[ChainStep]) -> str:
    import math

    lines = ["step,nnz,flops,seconds,nnz_per_s,gflops"]
    for r in results:
        if math.isnan(r.seconds):
            continue  # untimed step (per_step=False fast path)
        lines.append(
            f"{r.step},{r.nnz},{r.flops},{r.seconds:.6f},{r.nnz_per_s:.1f},{r.gflops:.3f}"
        )
    return "\n".join(lines) + "\n"


def run_chain_mixed(
    a: SparseCSR,
    native_stats: list,
    max_step: int = 7,
    switch_step: int = 5,
    iters: int = 3,
    reps: int = 4,
    slab_reps: int = 8,
    verbose: bool = True,
) -> Tuple[List[ChainStep], float]:
    """Mixed-kernel chain: slab ESC for the sparse early steps, the
    dense-accumulator kernel for the dense late steps — the whole chain
    against the CPU reference, not just A^7.

    Steps 2..switch_step-1 run the slab kernel with fused-rep numeric
    timing (fixed plan, spgemm_bench protocol); then the sparse power
    densifies (TIMED — the transition is a real cost, and
    the reported total includes it) and steps switch_step..max_step run
    the dense-accumulator kernel with prefix-differential timing.

    Returns (per-step records, total_seconds) where total_seconds =
    sum(early numeric steps) + densify + sum(late differentials): the
    number to put against the reference CSR-par chain total (~102 ms,
    BASELINE.md).
    """
    import dataclasses

    from ..kernels import spmm_pallas as sp
    from ..ops import slab as slab_mod
    from ..ops.spgemm import narrow_u64_ok
    from .timing import fused_loop_time_args

    assert 2 < switch_step <= max_step + 1
    stats_by_step = {s[0]: s for s in native_stats}
    results: List[ChainStep] = []
    total = 0.0

    # ---- early steps: slab ESC, per-step fixed-plan fused timing
    cur = a
    for step in range(2, switch_step):
        narrow = a.sr_name == "u64" and narrow_u64_ok(cur, a)
        rc_dev, nch_total, sg_dev = slab_mod.plan_device(cur, a,
                                                         slab_mod.DEFAULT_C)
        rc = np.asarray(jax.device_get(rc_dev)).astype(np.int64)
        ncc = max(int(jax.device_get(nch_total)), 1)
        sg = _pow2(max(int(jax.device_get(sg_dev)), 1))
        _, want_nnz, _, flops = stats_by_step[step]
        out_cap = _pow2(flops)
        lc = slab_mod.DEFAULT_L // slab_mod.DEFAULT_C
        assert not (rc > lc).any(), "torus chain rows must fit one block"
        sel, starts, nb = slab_mod.pack_rows_ordered(rc, lc)
        sel_d, starts_d = jnp.asarray(sel), jnp.asarray(starts)
        rc_d = jnp.asarray(rc.astype(np.int32))

        c = slab_mod._numeric(cur, a, sel_d, starts_d, rc_d,
                              slab_mod.DEFAULT_C, slab_mod.DEFAULT_L, nb,
                              ncc, sg, out_cap, narrow)
        nnz = int(c.nnz)
        assert nnz == want_nnz, (step, nnz, want_nnz)

        def _bump_step(bump, cur_, a_, sel_x, starts_x, rc_x,
                       _st=(nb, ncc, sg, out_cap, narrow)):
            nb_x, ncc_x, sg_x, cap_x, nar_x = _st
            cur2 = dataclasses.replace(
                cur_, col_idx=cur_.col_idx + (bump * 1e-30).astype(jnp.int32))
            out = slab_mod._numeric(cur2, a_, sel_x, starts_x, rc_x,
                                    slab_mod.DEFAULT_C, slab_mod.DEFAULT_L,
                                    nb_x, ncc_x, sg_x, cap_x, nar_x)
            return out.col_idx[0].astype(jnp.float32)

        dt = fused_loop_time_args(
            _bump_step, (cur, a, sel_d, starts_d, rc_d),
            reps=slab_reps, iters=iters)
        total += dt
        rec = ChainStep(step=step, nnz=nnz, flops=flops, seconds=dt,
                        nnz_per_s=nnz / dt, gflops=2.0 * flops / dt / 1e9)
        results.append(rec)
        if verbose:
            print(f"A^{step} [slab]: nnz={nnz} flops={flops} "
                  f"time={dt*1e3:.2f}ms nnz/s={rec.nnz_per_s/1e6:.1f}M",
                  flush=True)
        cur = c

    if switch_step > max_step:
        return results, total

    # ---- transition: densify A^(switch-1), column-padded (timed)
    @jax.jit
    def densify(m: SparseCSR):
        return sp.pad_cols(tuple_to_f32_dense(m))

    p0 = densify(cur)
    jax.block_until_ready(p0)

    def _dens_step(bump, cur_):
        cur2 = dataclasses.replace(
            cur_, col_idx=cur_.col_idx + (bump * 1e-30).astype(jnp.int32))
        return densify(cur2)[0, 0]

    t_dens = fused_loop_time_args(_dens_step, (cur,), reps=slab_reps,
                                  iters=iters)
    total += t_dens
    if verbose:
        print(f"densify A^{switch_step-1} [transition]: "
              f"time={t_dens*1e3:.2f}ms", flush=True)

    # ---- late steps: dense-accumulator kernel, prefix differentials
    rp, ci, vals = sp.csr_operand(a)

    @jax.jit
    def timed_chain(p0_, bump, steps, reps_):
        def rep(r, carry):
            acc, _ = carry
            p = p0_.at[0, 0].add(bump + jnp.float32(r) + acc * 1e-30)
            p = jax.lax.fori_loop(
                0, steps, lambda i, q: sp.spmm_pallas(rp, ci, vals, q), p)
            return acc + p[0, 0], p

        return jax.lax.fori_loop(0, reps_, rep, (jnp.float32(0.0), p0_))

    n_late = max_step - switch_step + 1
    acc, p_final = timed_chain(p0, 0.0, n_late, 1)
    jax.block_until_ready(acc)

    def _time(steps):
        acc, _ = timed_chain(p0, 0.0, steps, reps)
        jax.block_until_ready(acc)
        best = float("inf")
        for it in range(iters):
            t0 = time.perf_counter()
            acc, _ = timed_chain(p0, float(it + 1), steps, reps)
            jax.block_until_ready(acc)
            best = min(best, time.perf_counter() - t0)
        return best / reps

    prefix = {s: _time(s) for s in range(n_late + 1)}
    for idx in range(n_late):
        step = switch_step + idx
        dt = max(prefix[idx + 1] - prefix[idx], 1e-9)
        _, nnz, vmax, flops = stats_by_step[step]
        if vmax >= float(1 << 24) - 8:
            raise OverflowError("mixed chain exceeds f32 exact range")
        total += dt
        rec = ChainStep(step=step, nnz=nnz, flops=flops, seconds=dt,
                        nnz_per_s=nnz / dt, gflops=2.0 * flops / dt / 1e9)
        results.append(rec)
        if verbose:
            print(f"A^{step} [dense-acc]: nnz={nnz} flops={flops} "
                  f"time={dt*1e3:.2f}ms nnz/s={rec.nnz_per_s/1e6:.1f}M",
                  flush=True)
    if verbose:
        print(f"chain total (A^2..A^{max_step}, incl. densify): "
              f"{total*1e3:.2f}ms  [reference CSR-par total ~102 ms]",
              flush=True)
    return results, total
