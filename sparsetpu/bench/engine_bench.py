"""Einsum engine-overhead benchmark: planner vs direct kernels.

The reference measures every engine tier against the hand-written kernels
(`linalg/benches/perf.rs:130-352`, `einsum-dyn/benches/einsum_bench.rs:84-181`,
`examples/jit_bench.rs:33-234`) and publishes the overhead table
(`SPARSE_EINSUM_APPROACHES.md:121-161`).  The analog here:

  - dense tier:   engine "ab,bc->ac" vs direct jnp.einsum
  - sparse tier:  engine CSR x CSR vs direct spgemm_auto
  - chain tier:   engine "ab,bc,cd->ad" vs manual pairwise spgemm
  - plan cost:    host-side planning time per call (parse + classify),
                  the analog of the JIT's one-time compile cost measurement
                  (linalg/src/jit.rs:460-468)

Emits CSV rows: case,impl,seconds,slowdown_vs_direct.
"""

from __future__ import annotations

import time
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..csr import SparseCSR
from ..einsum.engine import einsum
from ..graphs import generate
from ..ops.spgemm import spgemm_auto
from ..semiring import F32SR, U64
from .timing import fused_loop_time


def _rand_csr(n, m, nnz, seed, sr=U64):
    rng = np.random.default_rng(seed)
    return SparseCSR.from_coo(
        rng.integers(0, n, nnz), rng.integers(0, m, nnz),
        rng.integers(1, 5, nnz).astype(np.uint64), n, m, sr=sr,
    )


def run(n: int = 1024, nnz_per_row: int = 8, reps: int = 16,
        iters: int = 3, verbose: bool = True) -> str:
    rows: List[str] = []

    def emit(case, impl, secs, direct_secs):
        line = (f"{case},{impl},{secs:.6f},"
                f"{secs / max(direct_secs, 1e-12):.3f}")
        rows.append(line)
        if verbose:
            print(line, flush=True)

    header = "case,impl,seconds,slowdown_vs_direct"
    rows.append(header)
    if verbose:
        print(header, flush=True)

    # --- dense tier -------------------------------------------------------
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((n, n)).astype(np.float32))
    y = jnp.asarray(rng.standard_normal((n, n)).astype(np.float32))

    t_direct = fused_loop_time(
        lambda bump: jnp.einsum("ab,bc->ac", x + bump * 1e-30, y,
                                precision=jax.lax.Precision.HIGHEST,
                                preferred_element_type=jnp.float32)[0, 0],
        reps=reps, iters=iters)
    # engine calls are host-driven: each pays one device dispatch + sync,
    # which a fused-loop direct measurement amortizes away.  Time the
    # direct path BOTH ways so the engine row is compared against the same
    # per-call protocol and the fused row shows the pure kernel time.
    # Every f32 matmul here is HIGHEST, like the engine's own.
    jitted_mm = jax.jit(lambda x, y: jnp.einsum(
        "ab,bc->ac", x, y, precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32))
    jitted_mm(x, y)  # warm

    def percall(f):
        best = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            jax.block_until_ready(f())
            best = min(best, time.perf_counter() - t0)
        return best

    t_direct_call = percall(lambda: jitted_mm(x, y))
    # engine call: planning happens per call on the host; jit cache warm.
    # device-resident operands — feeding host arrays would time the
    # host-to-device transfer, not the engine
    einsum("ab,bc->ac", [x, y], sr=F32SR)  # warm
    best = percall(lambda: einsum("ab,bc->ac", [x, y], sr=F32SR)[0])
    emit(f"dense_matmul_{n}", "direct_fused", t_direct, t_direct)
    emit(f"dense_matmul_{n}", "direct_percall", t_direct_call,
         t_direct_call)
    emit(f"dense_matmul_{n}", "engine", best, t_direct_call)

    # --- sparse tier ------------------------------------------------------
    a = _rand_csr(n, n, n * nnz_per_row, 1)
    b = _rand_csr(n, n, n * nnz_per_row, 2)
    c_direct = spgemm_auto(a, b)  # warm + capacity discovery

    def direct_call():
        out = spgemm_auto(a, b)
        jax.block_until_ready(out.nnz)
        return out

    best_d = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        direct_call()
        best_d = min(best_d, time.perf_counter() - t0)

    einsum("ab,bc->ac", [a, b], sr=U64, out_format="sparse")  # warm
    best_e = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        (out,) = einsum("ab,bc->ac", [a, b], sr=U64, out_format="sparse")
        jax.block_until_ready(out.nnz)
        best_e = min(best_e, time.perf_counter() - t0)
    emit(f"spgemm_{n}x{nnz_per_row}", "direct_esc", best_d, best_d)
    emit(f"spgemm_{n}x{nnz_per_row}", "engine", best_e, best_d)

    # --- sparse x dense tier (SpMM lowering, engine.py:_lower_spmm) -------
    af = _rand_csr(n, n, n * nnz_per_row, 4, sr=F32SR)
    d = jnp.asarray(rng.standard_normal((n, n)).astype(np.float32))
    from ..ops.spmm import spmm_csr_dense

    t_spmm = fused_loop_time(
        lambda bump: spmm_csr_dense(af, d + bump * 1e-30)[0, 0], reps=reps,
        iters=iters)
    spmm_csr_dense(af, d)  # warm
    t_spmm_call = percall(lambda: spmm_csr_dense(af, d))
    einsum("ab,bc->ac", [af, d], sr=F32SR)  # warm
    best_s = percall(lambda: einsum("ab,bc->ac", [af, d], sr=F32SR)[0])
    emit(f"spmm_{n}x{nnz_per_row}", "direct_spmm_fused", t_spmm, t_spmm)
    emit(f"spmm_{n}x{nnz_per_row}", "direct_spmm_percall", t_spmm_call,
         t_spmm_call)
    emit(f"spmm_{n}x{nnz_per_row}", "engine", best_s, t_spmm_call)

    # --- chain tier -------------------------------------------------------
    c3 = _rand_csr(n, n, n * nnz_per_row, 3)

    def manual_chain():
        ab = spgemm_auto(a, b)
        out = spgemm_auto(ab, c3)
        jax.block_until_ready(out.nnz)
        return out

    manual_chain()  # warm
    best_m = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        manual_chain()
        best_m = min(best_m, time.perf_counter() - t0)

    einsum("ab,bc,cd->ad", [a, b, c3], sr=U64, out_format="sparse")  # warm
    best_c = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        (out,) = einsum("ab,bc,cd->ad", [a, b, c3], sr=U64,
                        out_format="sparse")
        jax.block_until_ready(out.nnz)
        best_c = min(best_c, time.perf_counter() - t0)
    emit(f"chain3_{n}x{nnz_per_row}", "manual_pairwise", best_m, best_m)
    emit(f"chain3_{n}x{nnz_per_row}", "engine", best_c, best_m)

    # --- planning cost (host-only) ---------------------------------------
    from ..einsum.parser import parse_spec, validate_dims

    t0 = time.perf_counter()
    n_plan = 1000
    for _ in range(n_plan):
        p = parse_spec("ab,bc,cd->ad")
        validate_dims(p, [(n, n), (n, n), (n, n)])
    plan_s = (time.perf_counter() - t0) / n_plan
    emit("plan_parse_validate", "host", plan_s, plan_s)

    return "\n".join(rows) + "\n"


def main(argv=None):
    import argparse
    import os

    ap = argparse.ArgumentParser(description=run.__doc__)
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--nnz-per-row", type=int, default=8)
    ap.add_argument("--out", default="bench_out/engine_bench.csv")
    args = ap.parse_args(argv)
    from . import configure_cache
    configure_cache()
    csv = run(n=args.n, nnz_per_row=args.nnz_per_row)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(csv)


if __name__ == "__main__":
    main()
