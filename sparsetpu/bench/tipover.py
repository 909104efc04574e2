"""Sparse-vs-dense attention tipover sweep (reference methodology).

Reproduces tipover_attention_bob (src/main.rs:54-195): per GPT config,
time the dense kernel, then sweep density over 17 log steps 1e-4 -> 1
(4 per decade), timing the sparse kernel and emitting the reference's CSV
schema ``impl,density,q_nz,k_nz,v_nz,mem_k,mem_q,mem_v,attn_time,gen_time,
attn_dry`` plus a dense header line ``ref_time=..`` — so the reference's
plotting/crossover scripts apply unchanged.

The sparse kernel here is the grouped ESC SpGEMM (attention/scores.py);
``attn_dry`` times the symbolic pass alone (the reference's traversal-only
timing, src/sparse.rs:109-111).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..attention import scores
from ..csr import SparseCSR
from ..ops.spgemm import spgemm, symbolic_flops

# (batch_size, sequence_length, n_heads, embedding_dim) — src/main.rs:46-52
GPT_CONFIGS: List[Tuple[int, int, int, int]] = [
    (32, 512, 12, 384),   # shakespeare-char
    (8, 1024, 12, 768),   # GPT-2 117M
    (8, 1024, 16, 1024),  # GPT-2 345M
    (8, 1024, 20, 1280),  # GPT-2 762M
    (8, 1024, 25, 1600),  # GPT-2 1542M XL
]


def config_shape(cfg) -> Tuple[int, int, int, int]:
    b, s, h, e = cfg
    return (b, s, h, e // h)


def _csr_mem_bytes(c: SparseCSR) -> int:
    nnz = int(c.nnz)
    return 4 * (c.n_rows + 1) + nnz * 4 * (1 + len(c.values))


def _pow2(x: int) -> int:
    return 1 << (max(int(x), 1) - 1).bit_length()


def _time(fn, iters: int = 3) -> float:
    fn()  # warmup/compile
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def dense_baseline(shape, iters: int = 3, reps: int = 64) -> float:
    from .timing import fused_loop_time

    rng = np.random.default_rng(0)
    q = rng.standard_normal(shape).astype(np.float32)
    k = rng.standard_normal(shape).astype(np.float32)
    qd, kd = jax.device_put(q), jax.device_put(k)

    def step(bump):
        out = scores.attention_scores_dense(qd + bump * 1e-30, kd)
        return out[0, 0, 0, 0]

    return fused_loop_time(step, reps=reps, iters=iters)


def sweep_config(cfg, iters: int = 2, n_density_steps: int = 17,
                 max_flops: int = 1 << 27, per_decade: int = 4,
                 reps: int = 64, verbose: bool = True,
                 out_path: str = None, densities=None,
                 with_sdd: bool = True) -> str:
    """One GPT config: dense baseline + density sweep. Returns CSV text.

    ``per_decade`` controls the log-density grid (the reference uses 4;
    every distinct step shape costs a fresh XLA compile).  ``reps`` fuses
    that many repetitions per timed dispatch, so the host dispatch + sync
    cost is divided by reps and does not drown microsecond kernels.  ``densities``: explicit grid
    overriding the log sweep (the reference's fine timing-bob.csv uses
    linear steps around the crossover); pow2 capacity bucketing keeps the
    number of distinct compiled programs far below the number of steps.
    ``with_sdd=False`` skips the block-sparse race (fine mode: the SDD
    time is density-flat, re-measuring it per fine step buys nothing)."""
    shape = config_shape(cfg)
    n_weights = int(np.prod(shape))
    dense_t = dense_baseline(shape, iters=iters, reps=reps)
    out = [f"ref_time={dense_t*1e6:.0f} µs blas_time={dense_t*1e6:.0f} µs "
           f"n_weights={n_weights} total_mem={3*n_weights*4}"]

    def _flush():
        # incremental write: a killed sweep keeps its partial results
        # (reference discipline: per-step std::fs::write, src/main.rs:194)
        if out_path:
            with open(out_path, "w") as f:
                f.write("\n".join(out) + "\n")
    header = "esc,density,q_nz,k_nz,v_nz,mem_k,mem_q,mem_v,attn_time,gen_time,attn_dry"
    out.append(header)
    _flush()
    if verbose:
        print(out[0], flush=True)
        print(header, flush=True)

    if densities is None:
        densities = [1e-4 * 10 ** (ii / float(per_decade))
                     for ii in range(n_density_steps)]
    for ii, density in enumerate(densities):
        if density > 1.0:
            break
        t0 = time.perf_counter()
        q = scores.random_sparse_tensor(shape, density, seed=2 * ii)
        k = scores.random_sparse_tensor(shape, density, seed=2 * ii + 1)
        q_csr = scores.tensor_to_grouped_csr(q)
        kt_csr = scores.tensor_to_grouped_csr(k, transpose_last=True)
        gen_time = time.perf_counter() - t0
        q_nz, k_nz = int(q_csr.nnz), int(kt_csr.nnz)

        from .timing import fused_loop_time

        flops = int(symbolic_flops(q_csr, kt_csr))
        cap = _pow2(flops)
        # adaptive reps: low-density steps run tiny ESC programs, so fuse
        # more of them per dispatch — the floor scales as sync_cost / reps
        step_reps = int(min(1024, max(reps, (1 << 24) // max(cap, 1))))
        # the cap guard is a memory/runtime budget — skip esc past it,
        # keep sweeping for sdd
        if flops > max_flops or cap > (1 << 24):
            # the sort-based path cannot materialize this expansion on one
            # chip; keep sweeping — the block-sparse SDD row below is
            # compute-bounded by the dense shape and runs to density 1.0
            if verbose:
                print(f"# density {density:.4f}: esc skipped "
                      f"(flops {flops} > budget)", flush=True)
        else:
            def dry_step(bump):
                # symbolic_flops reads only structure (col_idx / row_ptr /
                # nnz), so a value perturbation would be DCE'd and the
                # probe hoisted out of the timing loop.  Instead perturb
                # col_idx by a runtime-zero term derived from bump: the
                # flop count gathers through col_idx, so the probe is live
                # and loop-variant.
                zero_i32 = (bump * 1e-30).astype(jnp.int32)
                q2 = dataclasses.replace(
                    q_csr, col_idx=q_csr.col_idx + zero_i32)
                return symbolic_flops(q2, kt_csr).astype(jnp.float32)

            dry = fused_loop_time(dry_step, reps=step_reps, iters=iters)
            c = spgemm(q_csr, kt_csr, cap)

            def attn_step(bump):
                q2 = dataclasses.replace(
                    q_csr, values=(q_csr.values[0] + bump * 1e-30,)
                )
                out = spgemm(q2, kt_csr, cap)
                return out.values[0][0]

            attn = fused_loop_time(attn_step, reps=step_reps, iters=iters)
            v_nz = int(c.nnz)
            row = (
                f"esc,{density:.4f},{q_nz},{k_nz},{v_nz},"
                f"{_csr_mem_bytes(kt_csr)},{_csr_mem_bytes(q_csr)},"
                f"{_csr_mem_bytes(c)},"
                f"{attn*1e6:.0f},{gen_time*1e6:.0f},{dry*1e6:.0f}"
            )
            out.append(row)
            _flush()
            if verbose:
                print(row, flush=True)

        if not with_sdd:
            continue
        # block-sparse SDD race (the reference Chunked competitor,
        # src/main.rs:313): block structure built once per density; the
        # pair list is pow2-padded with duplicates of pair 0 to bound
        # per-density recompiles (measured time is thus a <= 2x upper
        # bound at low block counts — disclosed, nblocks in mem_v column)
        from ..kernels import blocksparse

        t0 = time.perf_counter()
        _, qi, ki, meta = blocksparse.block_sparse_attention_scores(q, k)
        sdd_gen = time.perf_counter() - t0
        nblocks = int(qi.shape[0])
        tpad = _pow2(nblocks)
        qi_p = jnp.concatenate(
            [qi, jnp.broadcast_to(qi[:1], (tpad - nblocks,))])
        ki_p = jnp.concatenate(
            [ki, jnp.broadcast_to(ki[:1], (tpad - nblocks,))])
        qf, kf = meta["qf"], meta["kf"]

        def sdd_step(bump):
            blk = blocksparse.sdd_block_scores(qf + bump * 1e-30, kf,
                                               qi_p, ki_p)
            return blk[0, 0, 0]

        sdd_t = fused_loop_time(sdd_step, reps=step_reps, iters=iters)
        mem = int(tpad) * meta["block"] * meta["block"] * 4
        row = (
            f"sdd,{density:.4f},{q_nz},{k_nz},{nblocks},"
            f"{kf.size * 4},{qf.size * 4},{mem},"
            f"{sdd_t*1e6:.0f},{sdd_gen*1e6:.0f},0"
        )
        out.append(row)
        _flush()
        if verbose:
            print(row, flush=True)
    return "\n".join(out) + "\n"


def crossover_density(csv_text: str) -> Optional[float]:
    """First density where sparse attn_time exceeds the dense ref_time
    (plot_crossover.py methodology)."""
    lines = csv_text.strip().split("\n")
    ref_us = float(lines[0].split("ref_time=")[1].split(" ")[0])
    last_below = None
    for line in lines[2:]:
        parts = line.split(",")
        if len(parts) < 9 or parts[0] != "esc":
            continue
        density, attn_us = float(parts[1]), float(parts[8])
        if attn_us <= ref_us:
            last_below = density
        else:
            return last_below
    return last_below


def main(argv=None):
    """CLI analog of the reference `pathmap_sla` binary (src/main.rs:289-311):
    run the attention tipover sweep per GPT config, writing
    ``bob_results_{i}.csv``-style files (named ``tipover_results_{i}.csv``)."""
    import argparse
    import os

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--configs", type=int, nargs="*", default=[0],
                        help="GPT config indices (0..4), default [0]")
    parser.add_argument("--out-dir", default="bench_out")
    parser.add_argument("--iters", type=int, default=2)
    parser.add_argument("--max-flops", type=int, default=1 << 27)
    parser.add_argument("--per-decade", type=int, default=4)
    parser.add_argument("--reps", type=int, default=64)
    parser.add_argument("--fine", action="store_true",
                        help="linear density steps around the measured "
                             "crossover band (the reference's fine "
                             "timing-bob.csv, 1%%-step analog) instead of "
                             "the 4-per-decade log sweep; esc only")
    args = parser.parse_args(argv)
    from . import configure_cache
    configure_cache()
    os.makedirs(args.out_dir, exist_ok=True)
    densities = None
    if args.fine:
        # sample 0.05%..1% in 0.05% steps (20 cells, ~6 distinct pow2
        # capacities) around the crossover band
        densities = [ii * 5e-4 for ii in range(1, 21)]
    for ci in args.configs:
        cfg = GPT_CONFIGS[ci]
        print(f"# config {ci}: batch={cfg[0]} seq={cfg[1]} heads={cfg[2]} "
              f"emb={cfg[3]}", flush=True)
        name = ("tipover_fine_{}.csv" if args.fine
                else "tipover_results_{}.csv").format(ci)
        path = os.path.join(args.out_dir, name)
        csv = sweep_config(cfg, iters=args.iters, max_flops=args.max_flops,
                           per_decade=args.per_decade, reps=args.reps,
                           out_path=path, densities=densities,
                           with_sdd=not args.fine)
        with open(path, "w") as f:
            f.write(csv)
        x = crossover_density(csv)
        print(f"# crossover density: {x}", flush=True)


if __name__ == "__main__":
    main()
