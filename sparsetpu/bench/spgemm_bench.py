"""General-SpGEMM benchmark: ESC vs row-categorized vs library baseline.

BASELINE configs 3-4 (random ER side x e/n grid; power-law skewed degrees)
raced across the kernels that produce *sparse* outputs, with the reference
discipline: nnz-agreement asserts before timing
(src/graph_magnus.rs:859-881), then fused-loop timed dispatches.

CSV schema: case,n,e_per_n,nnz_a,flops,nnz_c,algo,seconds,mproducts_per_s
(the repo analog of the reference bench_matmul_magnus CSV,
src/graph_magnus.rs:790-929).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..csr import SparseCSR
from ..graphs import datasets, generate
from ..ops.rowcat import spgemm_rowcat
from ..ops.spgemm import spgemm, symbolic_flops_exact
from ..semiring import U64
from .timing import fused_loop_time


def _pow2(x: int) -> int:
    return 1 << (max(int(x), 1) - 1).bit_length()


def _time_esc(a: SparseCSR, cap: int, reps: int, iters: int) -> float:
    spgemm(a, a, cap).check()

    def step(bump):
        a2 = dataclasses.replace(
            a, col_idx=a.col_idx + (bump * 1e-30).astype(jnp.int32))
        out = spgemm(a2, a, cap)
        return out.values[0][0].astype(jnp.float32)

    return fused_loop_time(step, reps=reps, iters=iters)


def _time_rowcat(a: SparseCSR, reps: int, iters: int) -> float:
    """Fused-loop timing of the single-dispatch numeric phase with a fixed
    plan config — symmetric with the ESC timing (which also excludes its
    host-side capacity fetch).  The plan pass itself is one small program
    + one host sync per product in real use."""
    from ..ops.rowcat import (FUSE_MAX_CAP, _rowcat_unfused, rowcat_config,
                              rowcat_numeric)

    fr, cat, perm, cats, of_cap, cap_g, cap = rowcat_config(a, a)
    if cap_g <= FUSE_MAX_CAP:
        rowcat_numeric(a, a, fr, cat, perm, cats, of_cap, cap_g, cap).check()

        def step(bump):
            a2 = dataclasses.replace(
                a, col_idx=a.col_idx + (bump * 1e-30).astype(jnp.int32))
            out = rowcat_numeric(a2, a, fr, cat, perm, cats, of_cap, cap_g,
                                 cap)
            return out.values[0][0].astype(jnp.float32)

        return fused_loop_time(step, reps=reps, iters=iters)

    # large shapes run the per-category dispatch path (the fused program's
    # compile grows too large); timing is per-call wall clock —
    # dispatches within a call pipeline asynchronously, the final
    # block_until_ready is the one sync.  The runtime dedups repeated
    # identical dispatches, so each call perturbs a guaranteed-padding
    # value slot (capacity extended by 8; padded slots are masked out of
    # every kernel) to make the argument bytes distinct.
    a_pad = a.with_capacity(a.capacity + 8)

    def call(k):
        v0 = a_pad.values[0].at[-1].set(
            jnp.asarray(k, a_pad.values[0].dtype))
        a2 = dataclasses.replace(a_pad, values=(v0, *a_pad.values[1:]))
        out = _rowcat_unfused(a2, a, fr, cat, perm, cats, of_cap, cap_g,
                              cap)
        jax.block_until_ready(out.nnz)
        return out

    call(0).check()  # warm every per-category jit
    best = float("inf")
    n_calls = max(reps // 4, 2)
    for it in range(max(iters, 1)):
        t0 = time.perf_counter()
        for j in range(n_calls):
            call(it * n_calls + j + 1)
        best = min(best, (time.perf_counter() - t0) / n_calls)
    return best


def _time_escb(a: SparseCSR, reps: int, iters: int) -> float:
    """Fused-loop timing of the blocked-ESC numeric dispatch with a fixed
    plan (host bin-packing excluded, symmetric with the ESC/rowcat
    timings; the plan is one n-sized fetch + an O(n log n) host pack)."""
    import dataclasses as _dc

    from ..ops import escb

    fr = np.asarray(jax.device_get(escb.row_flops(a, a))).astype(np.int64)
    total = int(fr.sum())
    L = escb.DEFAULT_L
    assert not (fr > L).any(), "wide rows: time spgemm_blocked directly"
    sel = np.flatnonzero(fr > 0)
    p2r, st, nb = escb.pack_rows(fr[sel], L)
    pack2row = jnp.asarray(sel[p2r].astype(np.int32))
    st = jnp.asarray(st)
    fr_dev = jnp.asarray(fr.astype(np.int32))
    cap = _pow2(total)
    escb._numeric(a, a, pack2row, st, fr_dev, L, nb, cap, cap).check()

    def step(bump):
        a2 = _dc.replace(
            a, col_idx=a.col_idx + (bump * 1e-30).astype(jnp.int32))
        out = escb._numeric(a2, a, pack2row, st, fr_dev, L, nb, cap, cap)
        return out.values[0][0].astype(jnp.float32)

    return fused_loop_time(step, reps=reps, iters=iters)


def _time_denseacc(a: SparseCSR, nnz_c: int, reps: int, iters: int) -> float:
    """Dense-accumulator path (ops/denseacc.py): fixed kernel operand,
    fused loop over the full numeric dispatch (densify + row SpMM + device
    CSR pack) — everything a caller would run per product."""
    import dataclasses as _dc

    from ..kernels.spmm_pallas import csr_operand
    from ..ops.denseacc import dense_acc_numeric

    op = csr_operand(a)
    cap = _pow2(nnz_c)

    def call(a2):
        return dense_acc_numeric(op, a2, cap)

    call(a).check()

    def step(bump):
        v0 = a.values[0] + (bump * 1e-30).astype(a.values[0].dtype)
        a2 = _dc.replace(a, values=(v0, *a.values[1:]))
        return call(a2).values[0][0].astype(jnp.float32)

    return fused_loop_time(step, reps=max(reps // 4, 1), iters=iters)


def _time_densedense(a: SparseCSR, nnz_c: int, reps: int,
                     iters: int) -> float:
    """Fully-dense route (ops/denseacc.py::spgemm_dense_dense): fused
    loop over the whole dispatch (densify both operands, one HIGHEST
    matmul, lane-sort pack) — everything a caller runs per product."""
    import dataclasses as _dc

    from ..ops.denseacc import densedense_numeric

    cap = _pow2(nnz_c)

    def call(a2):
        return densedense_numeric(a2, a, cap)

    call(a).check()

    def step(bump):
        v0 = a.values[0] + (bump * 1e-30).astype(a.values[0].dtype)
        a2 = _dc.replace(a, values=(v0, *a.values[1:]))
        return call(a2).values[0][0].astype(jnp.float32)

    return fused_loop_time(step, reps=reps, iters=iters)


def _time_bcoo(a: SparseCSR, reps: int, iters: int) -> Optional[float]:
    """Library baseline column (jax.experimental.sparse); times only the
    jitted sparse-sparse dot, structure prep excluded."""
    try:
        from jax.experimental import sparse as jsparse

        from ..utils.bcoo import csr_to_bcoo

        am = csr_to_bcoo(a)

        @jax.jit
        def mm(data):
            m = jsparse.BCOO((data, am.indices), shape=am.shape)
            c = jsparse.bcoo_dot_general(
                m, m, dimension_numbers=(((1,), (0,)), ((), ())))
            return c.data[0]

        def step(bump):
            return mm(am.data + bump * 1e-30)

        return fused_loop_time(step, reps=max(reps // 4, 1), iters=iters)
    except Exception as e:  # library path may not lower on all backends
        print(f"# bcoo skipped: {type(e).__name__}: {e}", flush=True)
        return None


def run(sides=(1000, 3375, 8000, 27000), e_per_n=(2, 8, 32),
        power_law_sides=(27000,), algos=("esc", "escb", "rowcat"),
        reps: int = 16, iters: int = 2, verbose: bool = True,
        out_path: str = None, sort_max_flops: int = None,
        esc_max_cap: int = None, prelude: bool = True) -> str:
    rows: List[str] = ["case,n,e_per_n,nnz_a,flops,nnz_c,algo,seconds,"
                       "mproducts_per_s"]

    def _flush():
        # incremental write: killed sweeps keep partial results
        if out_path:
            with open(out_path, "w") as f:
                f.write("\n".join(rows) + "\n")
    if verbose:
        print(rows[0], flush=True)

    cases: List[Tuple[str, int, int, tuple]] = []
    for n in sides:
        for epn in e_per_n:
            cases.append(("er", n, epn,
                          generate.random_graph(n, n * epn, seed=n + epn)))
    for n in power_law_sides:
        cases.append(("powerlaw", n, 8, datasets.power_law(n, 8, seed=17)))

    # per-kernel product caps; the defaults are far above any cell in the
    # grid since the sort paths use native cumulative ops
    # (ops/segments.py)
    esc_max_cap = esc_max_cap or (1 << 28)
    sort_max_flops = sort_max_flops or (1 << 28)

    for case, n, epn, coo in cases:
        r, c, v, nn = coo
        a = SparseCSR.from_coo_host(r, c, v, nn, sr=U64,
                                    capacity=_pow2(len(r)))
        flops = symbolic_flops_exact(a, a)
        cap = _pow2(flops)
        # agreement first (reference discipline): nnz + leading-row values
        # against the native C++ oracle, then time.  The oracle is the
        # ground truth; the rowcat warmup doubles as its device check.
        from .. import native

        rp_h, ci_h, v_h = a.to_numpy()
        crp, _, _ = native.spgemm(
            native.as_host_csr(rp_h.astype(np.int64), ci_h, v_h),
            native.as_host_csr(rp_h.astype(np.int64), ci_h, v_h), nn)
        nnz_c = int(crp[-1])
        try:
            if not prelude:
                raise StopIteration  # every algo asserts vs nnz_c itself
            if flops > sort_max_flops:
                raise RuntimeError("DNF_compile")
            want = spgemm_rowcat(a, a).check()
            assert int(want.nnz) == nnz_c, (int(want.nnz), nnz_c)
        except StopIteration:
            pass
        except Exception as e:  # prelude failure must not kill the sweep
            line = (f"{case},{n},{epn},{int(a.nnz)},{flops},{nnz_c},"
                    f"rowcat,DNF_error,0.0")
            rows.append(line)
            _flush()
            if verbose:
                print(line + f"  # prelude {type(e).__name__}: "
                      f"{str(e)[:120]}", flush=True)
        # category mix (the MAGNUS dispatch picture, esp. for power-law)
        try:
            if not prelude:
                raise StopIteration
            from ..ops.rowcat import THRESHOLDS, plan

            _, _, _, stats = plan(a, a)
            stats_h = np.asarray(jax.device_get(stats))
            labels = [f"L{t}" for t in THRESHOLDS] + ["overflow"]
            mix = " ".join(f"{lb}:{int(rc)}" for lb, (rc, _) in
                           zip(labels, stats_h) if rc > 0)
            if verbose:
                dmax, dmean = datasets.degree_stats(coo)
                print(f"# catmix {case} n={n} e/n={epn}: {mix} "
                      f"(deg max={dmax} mean={dmean:.1f})", flush=True)
        except Exception as e:
            if verbose:
                print(f"# catmix {case} n={n} e/n={epn}: unavailable "
                      f"({type(e).__name__})", flush=True)
        for algo in algos:
            try:
                if algo == "esc":
                    if cap > esc_max_cap:
                        raise RuntimeError("DNF_compile")
                    esc_out = spgemm(a, a, cap).check()
                    assert int(esc_out.nnz) == nnz_c, (int(esc_out.nnz), nnz_c)
                    t = _time_esc(a, cap, reps, iters)
                elif algo == "escb":
                    if flops > sort_max_flops:
                        raise RuntimeError("DNF_compile")
                    from ..ops.escb import spgemm_blocked

                    escb_out = spgemm_blocked(a, a).check()
                    assert int(escb_out.nnz) == nnz_c, (int(escb_out.nnz),
                                                        nnz_c)
                    t = _time_escb(a, reps, iters)
                elif algo == "denseacc":
                    from ..ops.denseacc import spgemm_dense_acc

                    da_out = spgemm_dense_acc(a, a).check()
                    assert int(da_out.nnz) == nnz_c, (int(da_out.nnz), nnz_c)
                    t = _time_denseacc(a, nnz_c, reps, iters)
                elif algo == "densedense":
                    from ..ops.denseacc import (densedense_fits,
                                                spgemm_dense_dense)

                    if not densedense_fits(n, n, n):
                        raise RuntimeError("DNF_error")
                    dd_out = spgemm_dense_dense(a, a).check()
                    assert int(dd_out.nnz) == nnz_c, (int(dd_out.nnz), nnz_c)
                    t = _time_densedense(a, nnz_c, reps, iters)
                elif algo == "densedense_tiled":
                    from ..ops.denseacc import (densedense_tiled_panel_cols,
                                                spgemm_dense_dense_tiled)

                    w = densedense_tiled_panel_cols(n, n)
                    if not w:
                        raise RuntimeError("DNF_error")
                    ddt = spgemm_dense_dense_tiled(a, a, panel_cols=w).check()
                    assert int(ddt.nnz) == nnz_c, (int(ddt.nnz), nnz_c)
                    # host-driven two-sweep path: per-call wall clock
                    # (the per-panel nnz fetch is part of the algorithm)
                    import time as _time

                    best = float("inf")
                    for _ in range(max(iters, 1)):
                        t0 = _time.perf_counter()
                        out = spgemm_dense_dense_tiled(a, a, panel_cols=w)
                        jax.block_until_ready(out.nnz)
                        best = min(best, _time.perf_counter() - t0)
                    t = best
                elif algo == "rowcat":
                    if flops > sort_max_flops:
                        raise RuntimeError("DNF_compile")
                    t = _time_rowcat(a, reps, iters)
                elif algo == "bcoo":
                    tb = _time_bcoo(a, reps, iters)
                    if tb is None:
                        continue
                    t = tb
                else:
                    raise ValueError(algo)
            except ValueError:
                raise
            except Exception as e:  # record DNF, keep sweeping (ref: the
                # reference's memory-budget skip, src/graph_csr.rs:1344)
                kind = str(e) if str(e) == "DNF_compile" else "DNF_error"
                line = (f"{case},{n},{epn},{int(a.nnz)},{flops},{nnz_c},"
                        f"{algo},{kind},0.0")
                rows.append(line)
                _flush()
                if verbose:
                    print(line + f"  # {type(e).__name__}: {str(e)[:120]}",
                          flush=True)
                continue
            line = (f"{case},{n},{epn},{int(a.nnz)},{flops},{nnz_c},{algo},"
                    f"{t:.6f},{flops / t / 1e6:.1f}")
            rows.append(line)
            _flush()
            if verbose:
                print(line, flush=True)
    return "\n".join(rows) + "\n"


def main(argv=None):
    import argparse
    import os

    ap = argparse.ArgumentParser(description=run.__doc__)
    ap.add_argument("--sides", type=int, nargs="*",
                    default=[1000, 3375, 8000, 27000])
    ap.add_argument("--e-per-n", type=int, nargs="*", default=[2, 8, 32])
    ap.add_argument("--algos", nargs="*", default=["esc", "escb", "rowcat"])
    ap.add_argument("--power-law-sides", type=int, nargs="*", default=[27000])
    ap.add_argument("--reps", type=int, default=16)
    ap.add_argument("--out", default="bench_out/spgemm_sweep.csv")
    ap.add_argument("--no-prelude", action="store_true",
                    help="skip the rowcat agreement warmup + catmix print "
                         "(each algo still asserts vs the native oracle)")
    args = ap.parse_args(argv)
    from . import configure_cache
    configure_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    csv = run(sides=tuple(args.sides), e_per_n=tuple(args.e_per_n),
              power_law_sides=tuple(args.power_law_sides),
              algos=tuple(args.algos), reps=args.reps, out_path=args.out,
              prelude=not args.no_prelude)
    with open(args.out, "w") as f:
        f.write(csv)


if __name__ == "__main__":
    main()
