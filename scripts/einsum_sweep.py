"""Large-scale einsum differential sweep (the reference's signature test).

The reference enumerates ~19.5M (spec x sparse-mask) cases and checks VM
and JIT bit-exact against a naive loop-nest oracle
(linalg/tests/einsum_sweep.rs:1-41).  This is this engine's analog:

  - specs: exhaustive enumeration over alphabet {a,b,c,d}, 1-3 inputs of
    rank 1-4 (1-3 for multi-input) WITH repeated letters (traces), and
    every distinct-letter output permutation including scalar;
  - operand masks: every dense/CSR combination over the 2-D operands and
    dense/GroupedCSR over 3-D operands with distinct letters;
  - semirings: u64 (exact saturating oracle on numpy object arrays) AND
    f32 (small-integer values, bit-exact);
  - per-letter dims FIXED at a=2,b=3,c=4,d=5: asymmetric dims catch
    transposition bugs, and fixed dims bound the jit-compile key count.

The full product space is millions of cases; the runner enumerates it
deterministically, shuffles with a fixed seed, and takes the first
--cases cases (>= 100k for a full run — four orders beyond the CI
sweep).  Engine errors other than InvalidSpec
("Unsupported" = accepted fallback boundary, as JitError::Unsupported is
in the reference) count as mismatches.

Run:  python scripts/einsum_sweep.py --cases 120000 --out sweep.txt

The sweep runs on the host CPU backend (pinned via jax.config, as in
tests/conftest.py): it checks semantics, not speed, and the persistent
compile cache amortizes the per-(spec,kinds,shape) XLA:CPU compiles
across restarts.
"""

import argparse
import itertools
import os
import sys
import time

sys.path.insert(0, ".")

import jax

jax.config.update("jax_platforms", "cpu")

from sparsetpu.bench import configure_cache  # noqa: E402

configure_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

import numpy as np

DIMS = {"a": 2, "b": 3, "c": 4, "d": 5}
LETTERS = "abcd"
U64MAX = (1 << 64) - 1


def gen_specs():
    """Deterministic spec universe: (inputs tuple, output string)."""
    def strings(max_len):
        for ln in range(1, max_len + 1):
            for tup in itertools.product(LETTERS, repeat=ln):
                yield "".join(tup)

    specs = []
    one_in = list(strings(4))
    for s in one_in:
        used = sorted(set(s))
        for r in range(0, min(len(used), 3) + 1):
            for out in itertools.permutations(used, r):
                specs.append(((s,), "".join(out)))
    two_in = list(strings(3))
    for s1 in two_in:
        for s2 in two_in:
            used = sorted(set(s1) | set(s2))
            for r in range(0, min(len(used), 2) + 1):
                for out in itertools.permutations(used, r):
                    specs.append(((s1, s2), "".join(out)))
    # 3-input: matmul-chain-shaped + a few general shapes, rank <= 2
    short = [s for s in two_in if len(s) <= 2]
    for s1 in short:
        for s2 in short:
            for s3 in short:
                used = sorted(set(s1) | set(s2) | set(s3))
                for r in range(0, min(len(used), 2) + 1):
                    for out in itertools.permutations(used, r):
                        specs.append(((s1, s2, s3), "".join(out)))
    return specs


def mask_combos(inputs):
    """Operand-kind combinations: dense always; CSR for 2-D operands;
    GroupedCSR for 3-D operands with distinct letters."""
    choices = []
    for ix in inputs:
        c = ["dense"]
        if len(ix) == 2:
            c.append("csr")
        if len(ix) == 3 and len(set(ix)) == 3:
            c.append("grouped")
        choices.append(c)
    return list(itertools.product(*choices))


def build_operand(ix, kind, sr_name, rng):
    from sparsetpu import SparseCSR, U64
    from sparsetpu.grouped import GroupedCSR

    shape = tuple(DIMS[ch] for ch in ix)
    vals = rng.integers(0, 40, shape)
    vals = np.where(rng.random(shape) < 0.45, 0, vals)  # ~45% sparse
    if sr_name == "u64":
        vals = vals.astype(np.uint64)
        dense_op = tuple(
            np.asarray(l) for l in U64.from_numpy(vals))
    else:
        vals = vals.astype(np.float32)
        dense_op = vals
    if kind == "dense":
        return dense_op, vals
    # HOST CSR build with FIXED capacity: the device builder's input coo
    # length is data-dependent (nnz), so every case would be a fresh jit
    # compile key (measured: 5.6 s/case, all in from_coo compiles)
    from sparsetpu.semiring import F32SR
    sr = U64 if sr_name == "u64" else F32SR
    if kind == "csr":
        r, c = np.nonzero(vals)
        return SparseCSR.from_coo_host(
            r, c, vals[r, c], vals.shape[0], n_cols=vals.shape[1], sr=sr,
            capacity=32), vals
    # grouped: leading axis = group; block-diagonal flat host build
    g, nn, mm = vals.shape
    gb, rb, cb = np.nonzero(vals)
    flat = SparseCSR.from_coo_host(
        gb * nn + rb, gb * mm + cb, vals[gb, rb, cb], g * nn,
        n_cols=g * mm, sr=sr, capacity=64)
    from sparsetpu.grouped import GroupedCSR as _G

    return _G(flat=flat, g=g, n=nn, m=mm), vals


def oracle(inputs, out, dense_vals, sr_name):
    """Joint-space loop-nest oracle.  u64: numpy object arrays with
    per-product and post-sum clips (for non-negative values the fold of
    saturating adds equals min(true sum, MAX), and each product term is
    min(x*y, MAX))."""
    letters = sorted({ch for ix in inputs for ch in ix})
    joint = {ch: DIMS[ch] for ch in letters}
    shape = tuple(joint[ch] for ch in letters)
    if sr_name == "u64":
        prod = np.ones(shape, object)
    else:
        prod = np.ones(shape, np.float64)
    for ix, v in zip(inputs, dense_vals):
        arr = v.astype(object) if sr_name == "u64" else v.astype(np.float64)
        # diagonal extraction for repeated letters
        uniq = []
        for ch in ix:
            if ch not in uniq:
                uniq.append(ch)
        if len(uniq) != len(ix):
            grids = np.meshgrid(*[np.arange(joint[ch]) for ch in uniq],
                                indexing="ij")
            arr = arr[tuple(grids[uniq.index(ch)] for ch in ix)]
        # broadcast into joint space
        expand = [slice(None) if ch in uniq else None for ch in letters]
        order = [uniq.index(ch) for ch in letters if ch in uniq]
        arr = np.transpose(arr, np.argsort([letters.index(ch)
                                            for ch in uniq]))
        view_shape = [joint[ch] if ch in uniq else 1 for ch in letters]
        arr = arr.reshape(view_shape)
        if sr_name == "u64":
            prod = prod * arr
            prod = np.where(prod > U64MAX, U64MAX, prod)
        else:
            prod = prod * arr
    sum_axes = tuple(i for i, ch in enumerate(letters) if ch not in out)
    total = prod.sum(axis=sum_axes) if sum_axes else prod
    if sr_name == "u64":
        total = np.asarray(total, object)
        total = np.where(total > U64MAX, U64MAX, total)
    # reorder remaining axes to the requested output order
    rem = [ch for ch in letters if ch in out]
    if rem:
        perm = [rem.index(ch) for ch in out]
        total = np.transpose(total, perm)
    return total


def run_case(spec_inputs, out, kinds, sr_name, seed):
    from sparsetpu.einsum.engine import einsum
    from sparsetpu.einsum.parser import InvalidSpec
    from sparsetpu.semiring import F32SR, U64

    rng = np.random.default_rng(seed)
    ops, dense_vals = [], []
    for ix, kind in zip(spec_inputs, kinds):
        op, dv = build_operand(ix, kind, sr_name, rng)
        ops.append(op)
        dense_vals.append(dv)
    spec = ",".join(spec_inputs) + "->" + out
    sr = U64 if sr_name == "u64" else F32SR
    try:
        (got,) = einsum(spec, ops, sr=sr)
    except InvalidSpec:
        return "unsupported"
    want = oracle(spec_inputs, out, dense_vals, sr_name)
    if sr_name == "u64":
        got_np = U64.to_numpy(got).astype(object)
        okay = np.array_equal(got_np, want)
    else:
        got_np = np.asarray(got, np.float64)
        okay = np.array_equal(got_np, want)
    return "ok" if okay else f"MISMATCH {spec} {kinds} {sr_name} s{seed}"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", type=int, default=120000)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--out", default="bench_out/einsum_sweep.txt")
    ap.add_argument("--start", type=int, default=0,
                    help="resume offset: skip the first N cases (the case "
                    "order is deterministic — fixed generator seed — so a "
                    "killed run resumes where its last progress line left "
                    "off)")
    args = ap.parse_args()

    specs = gen_specs()
    rng = np.random.default_rng(20260820)
    order = rng.permutation(len(specs))
    cases = []
    for si in order:
        inputs, out = specs[si]
        for kinds in mask_combos(inputs):
            for sr_name in ("u64", "f32"):
                for seed in range(args.seeds):
                    cases.append((inputs, out, kinds, sr_name, seed))
        if len(cases) >= args.cases:
            break
    cases = cases[: args.cases]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    log = open(args.out, "a")

    def emit(s):
        print(s, flush=True)
        log.write(s + "\n")
        log.flush()

    emit(f"# einsum differential sweep r5: {len(cases)} cases over "
         f"{len(specs)} enumerable specs, dims {DIMS}, "
         f"start {time.strftime('%H:%M:%S')}"
         + (f", resuming at case {args.start}" if args.start else ""))
    t0 = time.time()
    n_ok = n_unsup = 0
    mismatches = []
    for i, (inputs, out, kinds, sr_name, seed) in enumerate(cases):
        if i < args.start:
            continue
        if (i + 1) % 1000 == 0:
            # every case is a fresh (spec, kinds) compile key, and holding
            # tens of thousands of live XLA:CPU executables exhausts LLVM
            # JIT code memory (measured: "Cannot allocate memory" at ~8k
            # cases).  Dropping the in-process caches bounds live
            # executables; the persistent disk cache makes re-JITs cheap.
            import gc

            jax.clear_caches()
            gc.collect()
        r = run_case(inputs, out, kinds, sr_name, seed)
        if r == "ok":
            n_ok += 1
        elif r == "unsupported":
            n_unsup += 1
        else:
            mismatches.append(r)
            emit(r)
        if (i + 1) % 2000 == 0:
            dt = time.time() - t0
            done = i + 1 - args.start
            emit(f"progress {i+1}/{len(cases)} ok={n_ok} "
                 f"unsupported={n_unsup} mismatches={len(mismatches)} "
                 f"{dt:.0f}s ({done/dt:.1f} cases/s)")
    emit(f"DONE cases={len(cases)} ok={n_ok} unsupported={n_unsup} "
         f"mismatches={len(mismatches)} wall={time.time()-t0:.0f}s")
    if mismatches:
        sys.exit(1)


if __name__ == "__main__":
    main()
