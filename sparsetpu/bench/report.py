"""Reporting: CSV -> markdown tables and crossover extraction.

The reference's L5 layer (csv2table.py, plot_crossover.py, plot_surface.py,
bench_report.md): benchmarks print CSV; these helpers turn the CSVs into
the committed markdown report.  Plotting is optional (matplotlib if
available, silently skipped otherwise — the image has no display).
"""

from __future__ import annotations

import io
import os
from typing import List, Optional, Sequence


def csv_to_markdown(csv_text: str, title: Optional[str] = None) -> str:
    """CSV text (first row header) -> GitHub markdown table
    (csv2table.py analog; ignores non-CSV noise lines like the reference's
    auto-extraction from mixed test output, plot_surface.py:17-33)."""
    lines = [l.strip() for l in csv_text.strip().split("\n") if l.strip()]
    rows = [l.split(",") for l in lines if "," in l]
    if not rows:
        return ""
    width = max(len(r) for r in rows)
    rows = [r for r in rows if len(r) == width]
    out = io.StringIO()
    if title:
        out.write(f"### {title}\n\n")
    header, data = rows[0], rows[1:]
    out.write("| " + " | ".join(header) + " |\n")
    out.write("|" + "---|" * len(header) + "\n")
    for r in data:
        out.write("| " + " | ".join(r) + " |\n")
    return out.getvalue()


def chain_report(results, baseline_ms: Optional[dict] = None) -> str:
    """Markdown table for chain results with reference-baseline comparison.

    ``baseline_ms`` maps step -> reference milliseconds (BASELINE.md CSR-par
    column by default)."""
    baseline_ms = baseline_ms or {
        2: 4.9, 3: 5.8, 4: 9.0, 5: 17.1, 6: 24.4, 7: 40.5  # CSR par, README.md:39-46
    }
    lines = [
        "| step | nnz | time (ms) | nnz/s | vs CSR-par (CPU) |",
        "|---|---|---|---|---|",
    ]
    for r in results:
        base = baseline_ms.get(r.step)
        speedup = f"{base / (r.seconds * 1e3):.2f}x" if base else "-"
        lines.append(
            f"| A^{r.step} | {r.nnz:,} | {r.seconds*1e3:.2f} | "
            f"{r.nnz_per_s/1e6:.1f}M | {speedup} |"
        )
    return "\n".join(lines) + "\n"


def try_plot_crossover(csv_texts: Sequence[str], out_png: str) -> bool:
    """Density-vs-time crossover plot (plot_crossover.py analog).
    Returns False when matplotlib is unavailable."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return False
    fig, ax = plt.subplots(figsize=(7, 5))
    for idx, text in enumerate(csv_texts):
        lines = text.strip().split("\n")
        ref_us = float(lines[0].split("ref_time=")[1].split(" ")[0])
        dens, times = [], []
        for line in lines[2:]:
            parts = line.split(",")
            if len(parts) >= 9 and parts[0] == "esc":
                dens.append(float(parts[1]))
                times.append(float(parts[8]))
        ax.plot(dens, times, marker="o", label=f"sparse cfg{idx}")
        ax.axhline(ref_us, linestyle="--", alpha=0.5)
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("density")
    ax.set_ylabel("attention time (µs)")
    ax.legend()
    os.makedirs(os.path.dirname(out_png) or ".", exist_ok=True)
    fig.savefig(out_png, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return True


def main(argv=None):
    """Assemble bench_report.md from bench_out CSVs (the reference's
    committed bench_report.md analog)."""
    import argparse
    import glob

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--bench-dir", default="bench_out")
    parser.add_argument("--out", default="bench_report.md")
    args = parser.parse_args(argv)

    parts = ["# sparsetpu benchmark report\n"]
    for path in sorted(glob.glob(os.path.join(args.bench_dir, "chain_*.csv"))):
        with open(path) as f:
            parts.append(csv_to_markdown(f.read(), title=os.path.basename(path)))
    tip = sorted(glob.glob(os.path.join(args.bench_dir, "tipover_results_*.csv")))
    for path in tip:
        with open(path) as f:
            text = f.read()
        parts.append(csv_to_markdown(text, title=os.path.basename(path)))
        lines = text.strip().split("\n")
        if lines and "ref_time=" in lines[0]:
            parts.append(f"\n`{lines[0]}`\n")
    for path in sorted(glob.glob(os.path.join(args.bench_dir, "scaling_*.csv"))):
        with open(path) as f:
            parts.append(csv_to_markdown(f.read(), title=os.path.basename(path)))
    for path in sorted(glob.glob(os.path.join(args.bench_dir,
                                              "spgemm_sweep*.csv"))):
        with open(path) as f:
            text = f.read()
        parts.append(csv_to_markdown(text, title=os.path.basename(path)))
        png = os.path.join(os.path.dirname(args.out) or ".", "reports",
                           "spgemm_surface.png")
        os.makedirs(os.path.dirname(png), exist_ok=True)
        if try_plot_spgemm_surface(text, png):
            parts.append(f"\n![spgemm surface]({png})\n")
    for path in sorted(glob.glob(os.path.join(args.bench_dir,
                                              "engine_bench*.csv"))):
        with open(path) as f:
            parts.append(csv_to_markdown(f.read(), title=os.path.basename(path)))
    with open(args.out, "w") as f:
        f.write("\n".join(parts))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()


def try_plot_chain(csv_text: str, out_png: str,
                   baseline_ms: Optional[dict] = None) -> bool:
    """Chain step-time plot vs the reference CPU baselines
    (plot_surface.py's role for the headline chain)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return False
    steps, times = [], []
    for line in csv_text.strip().split("\n")[1:]:
        parts = line.split(",")
        steps.append(int(parts[0]))
        times.append(float(parts[3]) * 1e3)
    ref_seq = {2: 4.0, 3: 14.8, 4: 43.9, 5: 101, 6: 192, 7: 358}
    ref_par = {2: 4.9, 3: 5.8, 4: 9.0, 5: 17.1, 6: 24.4, 7: 40.5}
    ref_mag = {2: 8.3, 3: 14.4, 4: 23.5, 5: 28.3, 6: 80.4, 7: 129}
    fig, ax = plt.subplots(figsize=(7, 5))
    ax.plot(steps, times, marker="o", label="sparsetpu")
    for name, ref in (("CSR seq (CPU)", ref_seq), ("CSR par (CPU)", ref_par),
                      ("MAGNUS par (CPU)", ref_mag)):
        xs = [s for s in steps if s in ref]
        ax.plot(xs, [ref[s] for s in xs], marker="s", alpha=0.6, label=name)
    ax.set_yscale("log")
    ax.set_xlabel("chain step k (A^k)")
    ax.set_ylabel("step time (ms)")
    ax.set_title("A^2..A^7 SpGEMM chain, 30^3 Moore torus")
    ax.legend()
    os.makedirs(os.path.dirname(out_png) or ".", exist_ok=True)
    fig.savefig(out_png, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return True


def try_plot_overhead(csv_text: str, out_png: str) -> bool:
    """DenseBTree storage-overhead sawtooth (plot_overhead.py analog)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return False
    ns, ovs = [], []
    for line in csv_text.strip().split("\n")[1:]:
        a, b = line.split(",")
        ns.append(int(a))
        ovs.append(float(b) * 100)
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(ns, ovs, lw=0.8)
    ax.axhline(100 / 15, linestyle="--", alpha=0.6,
               label="1/(K-1) asymptote (6.67%)")
    ax.set_xlabel("n keys")
    ax.set_ylabel("index overhead (%)")
    ax.legend()
    os.makedirs(os.path.dirname(out_png) or ".", exist_ok=True)
    fig.savefig(out_png, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return True


def try_plot_spgemm_surface(csv_text: str, out_png: str) -> bool:
    """Kernel-crossover surface over the side x e/n grid (the repo analog
    of the reference's surface_csr_vs_magnus.png, src/graph_magnus.rs:
    790-929): per (n, e_per_n) cell, the products/s of each algo and the
    winner."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import numpy as np

        lines = [l for l in csv_text.strip().split("\n")[1:] if l]
        data = {}
        for l in lines:
            case, n, epn, nnz_a, flops, nnz_c, algo, secs, mps = l.split(",")
            if case != "er" or secs.startswith("DNF"):
                continue
            data.setdefault((int(n), int(epn)), {})[algo] = float(mps)
        if not data:
            return False
        sides = sorted({k[0] for k in data})
        epns = sorted({k[1] for k in data})
        algos = sorted({a for v in data.values() for a in v})
        fig, axes = plt.subplots(1, len(algos) + 1,
                                 figsize=(4 * (len(algos) + 1), 3.6))
        for ax, algo in zip(axes, algos):
            grid = np.full((len(epns), len(sides)), np.nan)
            for (n, e), v in data.items():
                if algo in v:
                    grid[epns.index(e), sides.index(n)] = v[algo]
            im = ax.imshow(grid, origin="lower", aspect="auto",
                           cmap="viridis")
            ax.set_xticks(range(len(sides)), sides)
            ax.set_yticks(range(len(epns)), epns)
            ax.set_xlabel("side n")
            ax.set_ylabel("e/n")
            ax.set_title(f"{algo} Mproducts/s")
            for (n, e), v in data.items():
                if algo in v:
                    ax.text(sides.index(n), epns.index(e), f"{v[algo]:.0f}",
                            ha="center", va="center", color="w", fontsize=8)
            fig.colorbar(im, ax=ax)
        ax = axes[-1]
        win = np.full((len(epns), len(sides)), -1)
        for (n, e), v in data.items():
            if v:
                best = max(v, key=v.get)
                win[epns.index(e), sides.index(n)] = algos.index(best)
        ax.imshow(win, origin="lower", aspect="auto", cmap="tab10",
                  vmin=0, vmax=9)
        ax.set_xticks(range(len(sides)), sides)
        ax.set_yticks(range(len(epns)), epns)
        ax.set_title("winner")
        for (n, e), v in data.items():
            if v:
                ax.text(sides.index(n), epns.index(e), max(v, key=v.get),
                        ha="center", va="center", color="w", fontsize=8)
        fig.tight_layout()
        fig.savefig(out_png, dpi=120)
        plt.close(fig)
        return True
    except Exception as e:
        print(f"# surface plot skipped: {type(e).__name__}: {e}")
        return False
