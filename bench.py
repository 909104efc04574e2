#!/usr/bin/env python
"""Headline benchmark: A^2..A^7 SpGEMM chain on the 30^3 Moore torus, on a GPU.

Prints ONE JSON line: output nnz/s at the A^7 step (u64 saturating semiring)
vs the reference CPU baseline (CSR rayon-parallel ~289M nnz/s at A^7,
BASELINE.md), with the device it ran on and the card's name and power
limit.  The host-side graph build and the native C++ oracle chain run in a
worker thread beside device start-up and compilation.  Every run checks
each step's nnz (and, for the dense-accumulator chain, the final product's
values) against the oracle before it prints; a mismatch exits non-zero.
``--quick`` runs a small chain.

    python bench.py [--quick] [--algo auto|pallas|band|esc|rowcat|escb|mixed]
"""

import argparse
import json
import os
import sys
import threading
import time

T0 = time.time()


def log(msg):
    print(f"[{time.time()-T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true", help="small chain for smoke tests")
    parser.add_argument("--steps", type=int, default=7)
    parser.add_argument("--iters", type=int, default=3)
    parser.add_argument("--csv", type=str, default=None, help="write per-step CSV here")
    parser.add_argument("--profile", type=str, default=None,
                        help="write a jax.profiler trace to this directory")
    parser.add_argument("--reps", type=int, default=None,
                        help="whole-chain repetitions fused per timed "
                             "program (default 4; 32 with --quick so the "
                             "prefix differential stands clear of the "
                             "host clock's noise at small scale)")
    parser.add_argument("--switch-step", type=int, default=5,
                        help="mixed chain: first step on the dense "
                             "accumulator (earlier steps ride slab ESC)")
    parser.add_argument("--algo",
                        choices=["auto", "pallas", "band", "esc", "rowcat",
                                 "escb", "mixed"],
                        default="auto",
                        help="auto = self-route via ops.hybrid.choose_strategy "
                             "(the MagnusConfig role); pallas = row-streaming "
                             "dense-accumulator kernel (the densifying torus "
                             "chain); band = block-band dense kernel; esc = "
                             "sort-based general kernel; rowcat = "
                             "row-categorized batched kernel")
    args = parser.parse_args(argv)

    dims = (12, 12, 12) if args.quick else (30, 30, 30)

    # ---- host build + native oracle in a thread (pure numpy/C++, no jax)
    host_out = {}

    def host_work():
        from sparsetpu.bench.chain import build_torus_host, native_chain_stats_host

        t0 = time.time()
        h = build_torus_host(dims=dims)
        host_out["host_csr"] = h
        log(f"host build: n={h.n} nnz={h.nnz} ({time.time()-t0:.1f}s)")
        t0 = time.time()
        stats, final = native_chain_stats_host(
            h.row_ptr, h.col_idx, h.vals_u64(), h.n, args.steps
        )
        host_out["native_stats"] = stats
        host_out["native_final"] = final
        log(f"native oracle chain: A^{args.steps} nnz={stats[-1][1]} "
            f"max={stats[-1][2]} ({time.time()-t0:.1f}s)")

    def host_work_guarded():
        try:
            host_work()
        except BaseException as e:  # surfaced after join — threads die silent
            host_out["error"] = e

    # daemon: a failed device check exits at once, not after the oracle
    worker = threading.Thread(target=host_work_guarded, daemon=True)
    worker.start()

    import jax

    from sparsetpu.bench import configure_cache
    from sparsetpu.bench.device import card_name_power, require_gpu

    cache_dir = configure_cache()  # before the first compile
    device = require_gpu()
    card = card_name_power()
    log(f"device: {device} card: {card} cache: {cache_dir}")
    worker.join()
    if "error" in host_out:
        raise RuntimeError("host build/oracle thread failed") from host_out["error"]

    from sparsetpu.bench.chain import (
        chain_csv, run_chain, run_chain_band, run_chain_pallas,
        run_chain_rowcat, verify_final_values,
    )

    t0 = time.time()
    a = host_out["host_csr"].to_device()
    jax.block_until_ready(a.col_idx)
    log(f"device transfer: ({time.time()-t0:.1f}s)")
    native_stats = host_out["native_stats"]

    if args.algo == "auto":
        # system self-routing (the MagnusConfig role): inspect the matrix
        # and pick the kernel category for this chain
        from sparsetpu.ops.hybrid import choose_strategy

        strat = choose_strategy(a, steps=args.steps - 1)
        args.algo = {"dense-acc": "pallas", "band": "band"}.get(strat,
                                                                "rowcat")
        log(f"choose_strategy -> {strat} (algo={args.algo})")

    if args.profile:
        jax.profiler.start_trace(args.profile)

    reps = args.reps if args.reps is not None else (32 if args.quick else 4)
    keep_final = {}
    if args.algo == "pallas":
        results = run_chain_pallas(a, max_step=args.steps, iters=args.iters,
                                   reps=reps, keep_final=keep_final)
    elif args.algo == "mixed":
        from sparsetpu.bench.chain import run_chain_mixed

        results, chain_total = run_chain_mixed(
            a, native_stats, max_step=args.steps,
            switch_step=min(args.switch_step, args.steps + 1),
            iters=args.iters, reps=reps)
        log(f"mixed chain total: {chain_total*1e3:.3f}ms")
    elif args.algo == "rowcat":
        results = run_chain_rowcat(a, max_step=args.steps, iters=args.iters)
    elif args.algo == "escb":
        from sparsetpu.bench.chain import run_chain_escb

        results = run_chain_escb(a, max_step=args.steps, iters=args.iters)
    elif args.algo == "band":
        from sparsetpu.kernels.bandmm import cyclic_bandwidth

        half_width = cyclic_bandwidth(a)
        block = {1728: 108, 27000: 125}.get(a.n_rows, 125)
        log(f"cyclic bandwidth: {half_width}")
        results = run_chain_band(a, half_width=half_width, block=block,
                                 max_step=args.steps, iters=args.iters)
    else:
        results = run_chain(a, max_step=args.steps, iters=args.iters)
    if args.profile:
        jax.profiler.stop_trace()

    # per-step nnz agreement vs the oracle BEFORE publishing the number
    if len(results) != len(native_stats):
        raise SystemExit(f"{len(results)} chain steps, oracle has "
                         f"{len(native_stats)}")
    for rec, (step, want_nnz, *_rest) in zip(results, native_stats):
        if rec.step != step or rec.nnz != want_nnz:
            raise SystemExit(f"A^{rec.step}: nnz {rec.nnz} != native {want_nnz}")
    log(f"per-step nnz agreement vs native oracle OK ({len(results)} steps)")
    if "p" in keep_final:
        t0 = time.time()
        verify_final_values(a, host_out["native_final"], max_step=args.steps,
                            p=keep_final.pop("p"))
        log(f"value-level verification vs native oracle OK "
            f"({time.time()-t0:.1f}s)")

    last = results[-1]
    baseline_nnz_per_s = 289e6  # reference CSR-par at A^7 (BASELINE.md)
    record = {
        "metric": f"spgemm_chain_A{last.step}_nnz_per_s",
        "value": last.nnz_per_s,
        "unit": "nnz/s",
        "vs_baseline": last.nnz_per_s / baseline_nnz_per_s,
        "algo": args.algo,
        "device": device,
        "card": card,
    }
    print(json.dumps(record), flush=True)
    if args.csv:
        os.makedirs(os.path.dirname(args.csv) or ".", exist_ok=True)
        with open(args.csv, "w") as f:
            f.write(chain_csv(results))
    return {"record": record, "results": results, "native_stats": native_stats}


if __name__ == "__main__":
    main()
