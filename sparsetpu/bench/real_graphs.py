"""Real-graph-scale benchmark + structure analysis (BASELINE configs 3-4 at
citation-graph scale).

Mirrors the reference's real-graph study (bench_real_graphs
src/graph_csr.rs:1430-1470, analyze_graph_structure :1472-1530, bench_diameter
:1226-1319) at the same (n, edges) scales.  The reference loads
``gen-graphs/{cora,nell,ogbn_arxiv}.edges`` fetched over the network with
torch_geometric/ogb (requirements.txt); this system runs without network access, so when the
edge file is absent we substitute a preferential-attachment (power-law) graph
at the SAME node/edge counts — the skew is the property the kernels care
about (hub rows stress the categorization / bin-packing paths), and the
substitute is clearly labeled ``*_pl`` in the CSV.

Per graph:
  - structure analysis: components, degree min/median/avg/max, bandwidth
    before/after RCM (the analyze_graph_structure analog);
  - A^k power chain timings (csv: graph,n,edges,step,nnz_out,seconds,
    mproducts_per_s,algo) with the reference's budget-guard discipline
    (MAX_NNZ skip rows, src/graph_csr.rs:1344-1346) — DNF_budget rows
    instead of OOM/stalls.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Tuple

import numpy as np

from ..csr import SparseCSR
from ..graphs import datasets, generate
from ..semiring import U64

# real citation-graph sizes (directed edge counts as fetched by the
# reference's requirements.txt pipeline: Planetoid cora/nell, ogbn-arxiv)
GRAPHS = [
    ("cora", 2708, 10556),
    ("nell", 65755, 251550),
    ("ogbn_arxiv", 169343, 1166243),
]

MAX_EXPANSION = 1 << 28  # ~268M products: sort-path / algo budget guard
MAX_NNZ = 1 << 26        # stop the chain once the power is this dense
# tiled dense-accumulator budget: 2 sweeps x nnz(A) x n_panels row reads
# (kernels/spmm_pallas.py); the bound awaits an H100 re-fit (ROADMAP C4)
MAX_ROW_READS = 600_000_000
# sort-path routing bound, a memory bound: the blocked-ESC expansion
# materializes ~10 stream-sized arrays, so past ~32M products the
# dense-accumulator path is the safer route
SORT_MAX_FLOPS = 32_000_000
DENSE_FIT_BYTES = 6e9


def load_or_synthesize(name: str, n: int, m: int) -> Tuple[str, tuple]:
    path = os.path.join("gen-graphs", f"{name}.edges")
    if os.path.exists(path):
        return name, datasets.load_edges(path)
    # match the undirected edge count: power_law emits both directions.
    # zlib.crc32, not hash(): Python string hashing is randomized per
    # process, which made nnz_a drift between runs of the "same" graph
    import zlib

    # the generator aims at the published DIRECTED edge count (passing it
    # as per-undirected attachment would double the density) and the
    # moments are asserted
    m_per_node = max(1, round(m / n / 2))
    coo = datasets.power_law(n, m_per_node,
                             seed=zlib.crc32(name.encode()) % (1 << 31),
                             target_directed_edges=m)
    datasets.check_substitute(name, coo)
    return f"{name}_pl", coo


def structure_report(label: str, coo: tuple, a: SparseCSR,
                     with_rcm: bool = True) -> List[str]:
    from ..graphs import algos

    rows_np, _, _, n = coo
    deg = np.bincount(rows_np, minlength=n)
    comp = algos.connected_components(a)
    sizes = np.bincount(comp)
    sizes = np.sort(sizes[sizes > 0])[::-1]
    lines = [
        f"[{label}] n={n} nnz={int(a.nnz)}",
        f"  components: {len(sizes)} (top sizes {sizes[:5].tolist()}, "
        f"{int((sizes == 1).sum())} singletons)",
        f"  degree: min={deg.min()} median={int(np.median(deg))} "
        f"avg={deg.mean():.1f} max={deg.max()}",
    ]
    mb, ab = algos.bandwidth_stats(a)
    lines.append(f"  bandwidth (original): max={mb} avg={ab:.1f}")
    if with_rcm:
        t0 = time.perf_counter()
        a_rcm, _ = algos.rcm(a)
        t_rcm = time.perf_counter() - t0
        mb2, ab2 = algos.bandwidth_stats(a_rcm)
        lines.append(
            f"  bandwidth (RCM): max={mb2} avg={ab2:.1f} ({t_rcm*1e3:.0f} ms)"
            f"  reduction: max {mb/max(mb2,1):.1f}x avg {ab/max(ab2,1e-9):.1f}x"
        )
    return lines


def bench_chain(label: str, a: SparseCSR, max_power: int,
                iters: int = 2, verbose: bool = True,
                flush_fn=None) -> List[str]:
    """A^2..A^max_power with per-step timings and oracle nnz agreement on
    the first step (full-chain value agreement is the long test's job).

    Each step computes A x A^(k-1) — NOT A^(k-1) x A: the dense-accumulator
    paths read one dense row per entry OF THE SPARSE OPERAND per panel, so
    the sparse side must stay the original A (nnz fixed) while the growing
    power rides densified (the other orientation would price nell A^3 at
    nnz(A^2)=13.6M row reads per panel)."""
    import jax

    from ..ops.slab import spgemm_slab
    from ..ops.spgemm import spgemm_auto, symbolic_flops_exact
    from .. import native

    rows: List[str] = []
    n = a.n_rows
    flush = (lambda: flush_fn(rows)) if flush_fn else (lambda: None)

    # native-oracle agreement on A^2 (agreement-then-time discipline)
    rp_h, ci_h, v_h = a.to_numpy()
    base = native.as_host_csr(rp_h.astype(np.int64), ci_h, v_h)
    crp, _, _ = native.spgemm(base, base, n)

    from ..ops.spgemm import dense_acc_panel_cols

    padded_cols = -(-n // 1024) * 1024
    dense_fits = n * padded_cols * 4 * 2 <= DENSE_FIT_BYTES
    panel_w = dense_acc_panel_cols(n, DENSE_FIT_BYTES)
    n_panels = -(-n // panel_w) if panel_w else 0
    nnz_a = int(a.nnz)

    prev = a
    for step in range(2, max_power + 1):
        flops = symbolic_flops_exact(a, prev)
        padded_m = -(-n // 1024) * 1024
        t_tiled_est = (n * padded_m * 4.3e-9 if panel_w else float("inf"))
        if flops <= SORT_MAX_FLOPS:
            algo = "slab"
        elif dense_fits:
            algo = "denseacc"
        elif flops * 90e-9 < t_tiled_est and flops <= (1 << 28):
            # large-n scattered: the column-chunked slab (MAGNUS role)
            # costs per product where the tiled panel sweep pays the full
            # n x m frame regardless of sparsity (constants await an H100
            # re-fit, ROADMAP C4).  Capped at 2^28 products: the per-row interleave holds every
            # chunk's output plus the final arrays (~3x output bytes)
            algo = "colchunk"
        elif (panel_w and 2 * nnz_a * n_panels <= MAX_ROW_READS
              and min(flops, n * n) * 12 <= 5e9):
            # the second clause bounds the OUTPUT: col + two u64 limbs is
            # 12 B/entry and the output can reach min(flops, n^2) entries
            # (nell A^4 at 531M products ran out of memory on this)
            algo = "denseacc_tiled"
        else:
            # no path within budget: the sort kernels are past their
            # memory bound, and the tiled dense accumulator would blow the
            # row-read budget — an honest DNF row, not a stall
            kind = ("DNF_sort_ceiling" if not panel_w else "DNF_budget")
            line = f"{label},{n},{nnz_a},{step},{kind},{flops},0,auto"
            rows.append(line)
            flush()
            if verbose:
                print(line, flush=True)
            break

        def run_once():
            if algo == "slab":
                return spgemm_slab(a, prev)
            return spgemm_auto(a, prev, kernel=algo)

        try:
            c = run_once().check()
        except (ValueError, RuntimeError, jax.errors.JaxRuntimeError) as e:
            # JaxRuntimeError covers device RESOURCE_EXHAUSTED — a DNF
            # row per the budget discipline, not a crashed bench
            line = (f"{label},{n},{nnz_a},{step},DNF_{type(e).__name__},"
                    f"{flops},0,{algo}")
            rows.append(line)
            flush()
            if verbose:
                print(line, flush=True)
            break
        if step == 2:
            assert int(c.nnz) == int(crp[-1]), (int(c.nnz), int(crp[-1]))
        jax.block_until_ready(c.nnz)
        nnz_c = int(c.nnz)
        # at real-graph scale the output is GB-sized: holding the
        # agreement result alive through the timing loop doubles the peak
        # and fragments HBM (nell A^4 OOM'd on the SECOND call) — keep at
        # most one output alive at any moment
        last_step = nnz_c > MAX_NNZ or step == max_power
        del c
        best = float("inf")
        out = None
        try:
            for _ in range(iters):
                del out
                out = None
                t0 = time.perf_counter()
                out = run_once()
                jax.block_until_ready(out.nnz)
                best = min(best, time.perf_counter() - t0)
        except jax.errors.JaxRuntimeError:
            if best == float("inf"):
                line = (f"{label},{n},{nnz_a},{step},DNF_retime,"
                        f"{flops},0,{algo}")
                rows.append(line)
                flush()
                if verbose:
                    print(line, flush=True)
                break
        line = (f"{label},{n},{nnz_a},{step},{nnz_c},{flops},"
                f"{best:.6f},{algo}")
        rows.append(line)
        flush()
        if verbose:
            print(f"{line}  ({flops/best/1e6:.1f} Mproducts/s)", flush=True)
        if last_step:
            break
        prev = out if out is not None else run_once()
    return rows


def bench_algos(label: str, a: SparseCSR, verbose: bool = True) -> List[str]:
    """Graph-algorithm timings at real-graph scale: reachability-sum and
    diameter-on-largest-component (reference bench_diameter,
    src/graph_csr.rs:1226-1319) with the budget-guard discipline.  CSV rows
    reuse the chain schema with step = algo name."""
    import jax

    from ..graphs import algos
    from ..ops.spgemm import symbolic_flops_exact

    rows: List[str] = []
    n = a.n_rows
    nnz_a = int(a.nnz)

    # reachability: pattern-stable sum A + A^2 + ... — the closure blows up
    # on dense-ish graphs, so guard with the A^2 expansion estimate
    flops2 = symbolic_flops_exact(a, a)
    if flops2 > MAX_EXPANSION:
        rows.append(f"{label},{n},{nnz_a},reachability,DNF_budget,"
                    f"{flops2},0,auto")
    else:
        try:
            t0 = time.perf_counter()
            # pattern mode: the reference's stability criterion is the nnz
            # pattern; path counts overflow exact ranges on dense closures
            total, k = algos.reachability_sum(a, pattern=True)
            jax.block_until_ready(total.nnz)
            dt = time.perf_counter() - t0
            rows.append(f"{label},{n},{nnz_a},reachability,"
                        f"{int(total.nnz)},{k},{dt:.6f},auto")
        except (ValueError, RuntimeError, jax.errors.JaxRuntimeError) as e:
            rows.append(
                f"{label},{n},{nnz_a},reachability,DNF_{type(e).__name__},"
                f"{flops2},0,auto")

    try:
        t0 = time.perf_counter()
        d = algos.diameter(a)
        dt = time.perf_counter() - t0
        rows.append(f"{label},{n},{nnz_a},diameter,{d},0,{dt:.6f},auto")
    except (ValueError, RuntimeError, jax.errors.JaxRuntimeError) as e:
        rows.append(f"{label},{n},{nnz_a},diameter,"
                    f"DNF_{type(e).__name__},0,0,auto")
    if verbose:
        for ln in rows:
            print(ln, flush=True)
    return rows


def bench_band_hybrid(label: str, a: SparseCSR, iters: int = 2,
                      verbose: bool = True) -> List[str]:
    """General graph through RCM + band/outlier hybrid, end-to-end (the
    README's general-graph band story, previously never demonstrated on a
    real-scale graph): RCM-reorder, split at the 90th-percentile |r-c|
    band, run C = A x A through the dense band kernel + column-gather +
    ESC-outlier paths, verify value agreement against spgemm_auto, then
    time both.  CSV rows reuse the chain schema (step = hybrid@halfwidth /
    esc_comparator)."""
    import jax

    from ..graphs import algos
    from ..ops import hybrid
    from ..ops.spgemm import spgemm_auto, symbolic_flops_exact

    rows: List[str] = []
    n = a.n_rows
    try:
        t0 = time.perf_counter()
        a_rcm, _ = algos.rcm(a)
        t_rcm = time.perf_counter() - t0
        rp, ci, _ = a_rcm.to_numpy()
        rr = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
        dist = np.abs(rr - ci.astype(np.int64))
        hw = int(-(-int(np.percentile(dist, 90)) // 128) * 128) or 128
        h = hybrid.hybrid_from_csr(a_rcm, hw, block=128)
        band_frac = int(h.band.nnz()) / max(int(a_rcm.nnz), 1)
        flops = symbolic_flops_exact(a_rcm, a_rcm)
    except (ValueError, OverflowError, RuntimeError) as e:
        rows.append(f"{label},{n},{int(a.nnz)},hybrid_setup,"
                    f"DNF_{type(e).__name__},0,0,band+esc")
        if verbose:
            print(rows[-1] + f"  # {e}", flush=True)
        return rows
    if verbose:
        print(f"# [{label}] RCM {t_rcm*1e3:.0f} ms; half_width={hw} "
              f"band covers {band_frac:.1%} of nnz "
              f"(outliers {int(h.outliers.nnz)})", flush=True)

    def run_hybrid():
        c = hybrid.hybrid_matmul(h, h, a_csr=a_rcm)
        return c.to_csr(a_rcm.sr)

    try:
        got = run_hybrid().check()
        ref = spgemm_auto(a_rcm, a_rcm).check()
        assert int(got.nnz) == int(ref.nnz), (int(got.nnz), int(ref.nnz))
        gr, gc, gv = got.to_numpy()
        rr2, rc2, rv = ref.to_numpy()
        assert np.array_equal(gr, rr2) and np.array_equal(gc, rc2)
        assert np.array_equal(gv, rv), "value mismatch band-hybrid vs esc"
    except (ValueError, OverflowError, AssertionError, RuntimeError) as e:
        rows.append(f"{label},{n},{int(a.nnz)},hybrid@{hw},"
                    f"DNF_{type(e).__name__},{flops},0,band+esc")
        if verbose:
            print(rows[-1] + f"  # {e}", flush=True)
        return rows
    for name, fn, out in (("hybrid@%d" % hw, run_hybrid, got),
                          ("esc_comparator", lambda: spgemm_auto(
                              a_rcm, a_rcm), ref)):
        best = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            c = fn()
            jax.block_until_ready(c.nnz)
            best = min(best, time.perf_counter() - t0)
        rows.append(f"{label},{n},{int(a.nnz)},{name},{int(out.nnz)},"
                    f"{flops},{best:.6f},band+esc")
        if verbose:
            print(rows[-1], flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graphs", nargs="*",
                    default=[g[0] for g in GRAPHS])
    ap.add_argument("--max-power", type=int, default=4)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--no-rcm", action="store_true",
                    help="skip the RCM pass (host BFS; minutes at 169k)")
    ap.add_argument("--algos", action="store_true",
                    help="also time reachability/diameter per graph")
    ap.add_argument("--band-hybrid", action="store_true",
                    help="also run the RCM + band/outlier hybrid A^2")
    ap.add_argument("--out", default="bench_out/real_graphs.csv")
    args = ap.parse_args(argv)
    from . import configure_cache

    configure_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    header = "graph,n,nnz_a,step,nnz_out,flops,seconds,algo"
    all_rows = [header]
    print(header, flush=True)
    for name, n, m in GRAPHS:
        if name not in args.graphs:
            continue
        label, coo = load_or_synthesize(name, n, m)
        r, c, v, nn = coo
        a = SparseCSR.from_coo_host(r, c, v, nn, sr=U64)
        for ln in structure_report(label, coo, a, with_rcm=not args.no_rcm):
            print("# " + ln, flush=True)
        def _flush(pending):
            # incremental: a killed run keeps completed steps
            with open(args.out, "w") as f:
                f.write("\n".join(all_rows + pending) + "\n")

        def _write():
            with open(args.out, "w") as f:
                f.write("\n".join(all_rows) + "\n")

        all_rows += bench_chain(label, a, args.max_power, iters=args.iters,
                                flush_fn=_flush)
        _write()
        if args.band_hybrid:
            # hybrid before algos: the closure-building algorithms are the
            # HBM-heaviest stage — run them last so an OOM there cannot
            # take earlier sections' rows with it
            all_rows += bench_band_hybrid(label, a, iters=args.iters)
            _write()
        if args.algos:
            all_rows += bench_algos(label, a)
            _write()
    print(f"# wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
