#!/usr/bin/env python
"""On-card smoke test: drive the system's entry points on one NVIDIA GPU at
full size and check every result against an independent reference.

Phases (each prints its wall time and the device's peak memory so far):
  0. device   — JAX must find a GPU; prints the card, JAX version, cache;
  1. chain    — bench.py's default route: the torus30 A^2..A^7 chain, every
                step's nnz and the final values exact vs the native oracle;
  2. spgemm   — spgemm_auto on ER 27000x8, the pl27k power-law graph and the
                nell substitute (also forced onto denseacc_tiled), each
                exactly equal to the native oracle;
  3. attention — GPT-2 117M scores: dense, grouped sparse at density 0.05
                and the block-sparse SDD path vs float64 numpy;
  4. graphs   — components, reachability and diameter on the cora
                substitute vs scipy;
  5. einsum   — a dozen specs over dense and CSR operands, u64 and f32, vs
                the exact oracle;
  6. kernels  — the row-streaming SpMM kernel vs the plain XLA SpMM at the
                torus30 width, plus timings of the int32 GEMM, the int8
                pattern GEMM and the large sorts.
Any mismatch raises and exits non-zero.  The last line of standard output
is {"ok": true, "device": {...}}.

    python chip_smoke.py             # one card, every phase above
    python chip_smoke.py --chips 4   # only the row-sharded dist/ paths
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np

# the reference's agreement bound for f32 attention scores (src/main.rs:100-114)
ATTN_RTOL = 1e-4


# ---------------------------------------------------------------------------
# comparison functions (also unit-tested on tiny inputs on the CPU)
# ---------------------------------------------------------------------------

def _canonical(csr):
    """(row_ptr, col_idx, vals) with each row's entries sorted by column."""
    rp, ci, v = (np.asarray(x) for x in csr)
    rp = rp.astype(np.int64)
    nnz = int(rp[-1])
    rows = np.repeat(np.arange(len(rp) - 1), np.diff(rp))
    order = np.lexsort((ci[:nnz], rows))
    return rp, ci[:nnz][order].astype(np.int64), v[:nnz][order]


def csr_equal(got, want, what: str) -> None:
    """Exact equality of two host CSRs given as (row_ptr, col_idx, vals)."""
    g_rp, g_ci, g_v = _canonical(got)
    w_rp, w_ci, w_v = _canonical(want)
    if not np.array_equal(g_rp, w_rp):
        raise AssertionError(f"{what}: row pointers differ "
                             f"(nnz {g_rp[-1]} vs {w_rp[-1]})")
    if not np.array_equal(g_ci, w_ci):
        raise AssertionError(f"{what}: column indices differ")
    if not np.array_equal(g_v.astype(np.uint64), w_v.astype(np.uint64)):
        raise AssertionError(f"{what}: values differ")


def assert_close(got, want, rtol: float, what: str) -> float:
    """|got - want| <= rtol * max|want| elementwise; returns the observed
    relative error (max abs error over max |want|)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} != {want.shape}")
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - want).max(initial=0.0)) / scale
    if not np.isfinite(got).all() or err > rtol:
        raise AssertionError(f"{what}: relative error {err:.3g} > {rtol}")
    return err


def same_partition(a, b, what: str) -> None:
    """Two labelings describe the same partition of the nodes."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        raise AssertionError(f"{what}: {a.shape} vs {b.shape} labels")
    pairs = np.unique(np.stack([a, b], axis=1), axis=0)
    if not (len(pairs) == len(np.unique(a)) == len(np.unique(b))):
        raise AssertionError(f"{what}: partitions differ")


def reach_reference(adj):
    """Pattern of A + A^2 + ... (walks of length >= 1), from BFS distances."""
    from scipy.sparse.csgraph import shortest_path

    dist = shortest_path(adj, unweighted=True)
    finite = np.isfinite(dist).astype(np.float32)
    a = (adj.toarray() != 0).astype(np.float32)
    return (a @ finite) > 0


def diameter_reference(adj) -> int:
    """Longest finite shortest-path length (the squaring refinement's
    answer on the graph with self loops)."""
    from scipy.sparse.csgraph import shortest_path

    dist = shortest_path(adj, unweighted=True)
    return int(dist[np.isfinite(dist)].max())


def einsum_reference(spec: str, dense_ops, sr_name: str):
    """Exact reference: Python integers (then saturated) for u64, float64
    for f32."""
    if sr_name == "u64":
        ops = [np.asarray(x).astype(object) for x in dense_ops]
        out = np.asarray(np.einsum(spec, *ops), dtype=object)
        return np.minimum(out, 2**64 - 1)
    return np.einsum(spec, *(np.asarray(x, np.float64) for x in dense_ops))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def phase(name: str):
    import jax

    print(f"== phase {name}", flush=True)
    t0 = time.perf_counter()
    yield
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", 0) / 2**30
    print(f"== phase {name}: ok, {time.perf_counter() - t0:.1f} s wall, "
          f"device peak {peak:.2f} GiB so far", flush=True)


def _time(fn, iters: int = 5) -> float:
    """Best-of wall time of fn() ending in block_until_ready (warm first)."""
    import jax

    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def _native_square(a):
    from sparsetpu import native

    rp, ci, v = a.to_numpy()
    h = native.as_host_csr(rp.astype(np.int64), ci.astype(np.int32),
                           v.astype(np.uint64))
    return native.spgemm(h, h, a.n_rows)


def phase_chain(card: str):
    import bench

    out = bench.main([])  # the default route, every step timed
    for rec, (step, nnz, vmax, _flops) in zip(out["results"],
                                             out["native_stats"]):
        if rec.step != step or rec.nnz != nnz:
            raise AssertionError(f"A^{rec.step}: nnz {rec.nnz} != {nnz}")
        t = ("untimed" if rec.seconds != rec.seconds
             else f"{rec.seconds * 1e3:.3f} ms")
        print(f"  A^{step}: nnz={nnz} max={vmax} {t} [{card}]", flush=True)
    print(f"  route {out['record']['algo']}: "
          f"{out['record']['value'] / 1e6:.1f} M nnz/s at A^7 [{card}]")


def phase_spgemm():
    from sparsetpu import SparseCSR, spgemm_auto
    from sparsetpu.bench.configs import POWER_LAW
    from sparsetpu.bench.real_graphs import GRAPHS, load_or_synthesize
    from sparsetpu.graphs import datasets, generate

    pl = POWER_LAW["pl27k"]
    nell_label, nell = load_or_synthesize(
        *dict((g[0], g) for g in GRAPHS)["nell"])
    cases = [
        ("er27000x8", generate.random_graph(27000, 27000 * 8, seed=27008),
         ["auto"]),
        ("pl27k", datasets.power_law(pl.n, pl.m_per_node, seed=pl.seed),
         ["auto"]),
        (nell_label, nell, ["auto", "denseacc_tiled"]),
    ]
    for name, coo, kernels in cases:
        r, c, v, n = coo
        a = SparseCSR.from_coo_host(r, c, v, n)
        want = _native_square(a)
        for kernel in kernels:
            t0 = time.perf_counter()
            got = spgemm_auto(a, a, kernel=kernel)
            got_np = got.to_numpy()
            dt = time.perf_counter() - t0
            csr_equal(got_np, want, f"{name} A^2 [{kernel}]")
            print(f"  {name} n={n} nnz={int(a.nnz)} A^2 nnz={int(want[0][-1])}"
                  f" [{kernel}]: exact, {dt:.2f} s first call", flush=True)


def phase_attention():
    import jax

    from sparsetpu.attention import scores as att
    from sparsetpu.bench.tipover import GPT_CONFIGS, config_shape
    from sparsetpu.kernels import blocksparse as bs
    from sparsetpu.ops.spgemm import symbolic_flops

    shape = config_shape(GPT_CONFIGS[1])  # GPT-2 117M
    print(f"  shape (b, s, h, d) = {shape}; f32 matmuls at "
          f"precision=HIGHEST; bound rtol {ATTN_RTOL} of max|ref|")
    rng = np.random.default_rng(0)
    q = rng.standard_normal(shape).astype(np.float32)
    k = rng.standard_normal(shape).astype(np.float32)
    want = np.einsum("bshd,bsgd->bshg", q.astype(np.float64),
                     k.astype(np.float64))
    got = att.attention_scores_dense_jit(jax.device_put(q), jax.device_put(k))
    err = assert_close(jax.device_get(got), want, ATTN_RTOL, "dense scores")
    print(f"  dense: rel err {err:.2e}")

    qs = att.random_sparse_tensor(shape, 0.05, seed=1)
    ks = att.random_sparse_tensor(shape, 0.05, seed=2)
    want_s = np.einsum("bshd,bsgd->bshg", qs.astype(np.float64),
                       ks.astype(np.float64))
    q_csr = att.tensor_to_grouped_csr(qs)
    kt_csr = att.tensor_to_grouped_csr(ks, transpose_last=True)
    cap = 1 << (max(int(symbolic_flops(q_csr, kt_csr)), 1) - 1).bit_length()
    c = att.attention_scores_sparse(q_csr, kt_csr, cap).check()
    err = assert_close(att.sparse_scores_to_dense(c, shape), want_s,
                       ATTN_RTOL, "grouped sparse scores")
    print(f"  grouped sparse (density 0.05, {int(c.nnz)} nnz): "
          f"rel err {err:.2e}")

    blocks, qi, ki, meta = bs.block_sparse_attention_scores(q, k, block=128)
    err = assert_close(bs.scores_blocks_to_dense(blocks, qi, ki, meta), want,
                       ATTN_RTOL, "block-sparse SDD scores")
    print(f"  block-sparse SDD ({len(np.asarray(qi))} blocks): "
          f"rel err {err:.2e}")


def phase_graphs():
    import jax
    import scipy.sparse as ss
    from scipy.sparse.csgraph import connected_components

    from sparsetpu import SparseCSR
    from sparsetpu.bench.real_graphs import GRAPHS, load_or_synthesize
    from sparsetpu.graphs import algos, patterns

    label, coo = load_or_synthesize(*dict((g[0], g) for g in GRAPHS)["cora"])
    r, c, v, n = coo
    a = SparseCSR.from_coo_host(r, c, v, n)
    adj = ss.csr_matrix((np.ones(len(r)), (r, c)), shape=(n, n))
    print(f"  {label}: n={n} nnz={int(a.nnz)}")

    _, weak = connected_components(adj, directed=True, connection="weak")
    same_partition(algos.connected_components(a), weak, "components")
    _, strong = connected_components(adj, directed=True, connection="strong")
    same_partition(algos.connected_components_closure(a), strong,
                   "closure components")
    reach, _ = algos.reachability_sum(a, pattern=True)
    if not np.array_equal(reach.to_dense_numpy() != 0, reach_reference(adj)):
        raise AssertionError("reachability pattern differs")
    d = algos.diameter(a)
    if d != diameter_reference(adj):
        raise AssertionError(f"diameter {d} != {diameter_reference(adj)}")
    print(f"  components {len(np.unique(weak))}, reachability "
          f"{int(reach.nnz)} pairs, diameter {d}: exact")

    frame = patterns.from_csr(a, pad_to=patterns.bucket(n))
    mm = jax.jit(patterns.matmul)
    t = _time(lambda: mm(frame, frame))
    side = frame.shape[0]
    print(f"  int8 pattern GEMM {side}x{side}: {t * 1e3:.3f} ms "
          f"({2 * side**3 / t / 1e12:.1f} TOP/s)")


def phase_einsum():
    from sparsetpu import F32SR, U64, SparseCSR
    from sparsetpu.einsum.engine import einsum

    rng = np.random.default_rng(5)

    def dense(shape, hi, density=0.5):
        x = rng.integers(0, hi, size=shape) * (rng.random(shape) < density)
        return x

    big = np.uint64((1 << 62) + 7)
    cases = [  # (spec, shapes, formats (d=dense, s=csr), semiring)
        ("ab,bc->ac", [(512, 384), (384, 256)], "dd", "f32"),
        ("ab,bc->ac", [(512, 384), (384, 256)], "sd", "f32"),
        ("ab,bc->ac", [(512, 384), (384, 256)], "ss", "f32"),
        ("ba,bc->ac", [(384, 512), (384, 256)], "sd", "f32"),
        ("ab,b->a", [(512, 384), (384,)], "sd", "f32"),
        ("abc,cd->abd", [(16, 32, 64), (64, 48)], "dd", "f32"),
        ("ab,ab->", [(512, 384), (512, 384)], "ss", "f32"),
        ("ab,bc->ca", [(256, 192), (192, 128)], "ss", "f32"),
        ("ab,bc->ac", [(96, 80), (80, 64)], "ss", "u64"),
        ("ab,bc->ac", [(96, 80), (80, 64)], "sd", "u64"),
        ("ab,bc,cd->ad", [(64, 48), (48, 56), (56, 40)], "sss", "u64"),
        ("ab->a", [(96, 80)], "s", "u64"),
        ("aa->", [(96, 96)], "s", "u64"),
    ]
    for spec, shapes, fmts, srn in cases:
        sr = U64 if srn == "u64" else F32SR
        dense_ops = []
        for shp in shapes:
            x = dense(shp, 5 if srn == "f32" else 1000)
            if srn == "u64":
                x = x.astype(np.uint64)
                x[tuple(0 for _ in shp)] = big  # exercise saturation
            else:
                x = x.astype(np.float32)
            dense_ops.append(x)
        t0 = time.perf_counter()
        ops = []
        for x, f in zip(dense_ops, fmts):
            if f == "s":
                ops.append(SparseCSR.from_dense_numpy(x, sr=sr))
            else:
                ops.append(U64.from_numpy(x) if srn == "u64" else x)
        (got,) = einsum(spec, ops, sr=sr)
        got = U64.to_numpy(got) if srn == "u64" else np.asarray(got)
        t_engine = time.perf_counter() - t0
        want = einsum_reference(spec, dense_ops, srn)
        if srn == "u64":
            ok = np.array_equal(np.asarray(got).astype(object), want)
        else:  # small integers in f32: exact
            ok = np.array_equal(np.asarray(got, np.float64), want)
        if not ok:
            raise AssertionError(f"einsum {spec} [{fmts}, {srn}] differs")
        print(f"  {spec:14s} [{fmts:3s} {srn}]: exact; engine "
              f"{t_engine:.2f} s first call, reference "
              f"{time.perf_counter() - t0 - t_engine:.2f} s", flush=True)


def phase_kernels(card: str):
    import jax
    import jax.numpy as jnp

    from sparsetpu import SparseCSR
    from sparsetpu.bench.chain import build_torus_host, tuple_to_f32_dense
    from sparsetpu.graphs import generate
    from sparsetpu.kernels import spmm_pallas as sp
    from sparsetpu.ops import denseacc, spgemm as sg

    # row-streaming kernel vs a plain dense GEMM of the same product at
    # HIGHEST precision (exact: integers < 2^24).  XLA's gather +
    # segment_sum form (ops/spmm.spmm_csr_dense) fails to launch its
    # scatter fusion at this width (CUDA out of memory), so it cannot serve.
    h = build_torus_host()
    a = h.to_device()
    ad = jax.jit(tuple_to_f32_dense)(a)
    p = jax.jit(lambda x: jnp.dot(x, x, precision="highest"))(ad)  # A^2
    op = sp.csr_operand(a)
    p_pad = sp.pad_cols(p)
    kern = jax.jit(lambda x: sp.spmm_pallas(*op, x))
    plain = jax.jit(lambda x, y: jnp.dot(x, y, precision="highest"))
    same = jax.jit(lambda x, y: jnp.array_equal(x[:, : y.shape[1]], y))
    if not bool(same(kern(p_pad), plain(ad, p))):
        raise AssertionError("row SpMM kernel != dense GEMM at torus30")
    t_k, t_p = _time(lambda: kern(p_pad)), _time(lambda: plain(ad, p), 2)
    print(f"  row SpMM kernel {a.n_rows}x{p_pad.shape[1]}, nnz(A)="
          f"{int(a.nnz)}: {t_k * 1e3:.3f} ms; dense f32 GEMM (HIGHEST) "
          f"{t_p * 1e3:.3f} ms; exact [{card}]", flush=True)
    del ad, p, p_pad

    # int32 vs f32-HIGHEST dense-dense tiers on a 4096 ER graph
    r, c, vv, n = generate.random_graph(4096, 4096 * 16, seed=4096)
    g = SparseCSR.from_coo_host(r, c, vv, n)
    cap = 1 << (n * n - 1).bit_length()
    out_i = denseacc.densedense_numeric_i32(g, g, cap).check()
    out_f = denseacc.densedense_numeric(g, g, cap).check()
    csr_equal(out_i.to_numpy(), out_f.to_numpy(), "int32 vs f32 dense-dense")
    t_i = _time(lambda: denseacc.densedense_numeric_i32(g, g, cap).nnz, 3)
    t_f = _time(lambda: denseacc.densedense_numeric(g, g, cap).nnz, 3)
    ai = jnp.ones((n, n), jnp.int32)
    af = jnp.ones((n, n), jnp.float32)
    mm_i = jax.jit(lambda x: jax.lax.dot(x, x))
    mm_f = jax.jit(lambda x: jnp.dot(x, x, precision="highest"))
    print(f"  dense-dense n={n}: int32 tier {t_i * 1e3:.3f} ms, f32 tier "
          f"{t_f * 1e3:.3f} ms (incl. pack); bare GEMM int32 "
          f"{_time(lambda: mm_i(ai)) * 1e3:.3f} ms, f32 HIGHEST "
          f"{_time(lambda: mm_f(af)) * 1e3:.3f} ms", flush=True)

    # the large multi-operand sorts: ESC's global sort (ER 27000x8) and
    # the lane-sort pack of a whole torus30 frame
    r, c, vv, n = generate.random_graph(27000, 27000 * 8, seed=27008)
    e = SparseCSR.from_coo_host(r, c, vv, n)
    flops = sg.symbolic_flops_exact(e, e)
    cap = 1 << (flops - 1).bit_length()
    t_esc = _time(lambda: sg.spgemm(e, e, cap).nnz, 3)
    frame = jax.jit(tuple_to_f32_dense)(a)
    pack = jax.jit(lambda d: denseacc._dense_to_csr_lanesort(
        d, "u64", 1 << 18).nnz)
    t_pack = _time(lambda: pack(frame), 3)
    print(f"  ESC (expand + global sort) ER {n}x8, {flops} products: "
          f"{t_esc * 1e3:.3f} ms; lane-sort pack of a {frame.shape[0]}x"
          f"{frame.shape[1]} frame: {t_pack * 1e3:.3f} ms", flush=True)


def phase_dist4(card: str):
    """Row-sharded dist/ paths on the torus30 A^2..A^4, exact vs native."""
    import jax

    from sparsetpu import native
    from sparsetpu.bench.chain import build_torus_host
    from sparsetpu.dist import band as dband, panels, shard as dist
    from sparsetpu.kernels import bandmm

    nd = len(jax.devices())
    if nd < 4:
        raise SystemExit(f"--chips 4 needs 4 devices, JAX found {nd}")
    mesh = dist.default_mesh(4)
    h = build_torus_host()
    a = h.to_device()
    base = native.as_host_csr(h.row_ptr.astype(np.int64), h.col_idx[: h.nnz],
                              h.vals_u64())
    want, cur = {}, base
    for step in (2, 3, 4):
        cur = native.spgemm(cur, base, h.n)
        want[step] = cur

    def devices_of(x):
        return sorted({s.device.id for s in x.addressable_shards})

    s_esc = dist.shard(a, 4, mesh=mesh)
    s_ring = s_esc
    s_a = dist.shard(a, 4, mesh=mesh)
    band, outl = bandmm.csr_band_split(a, half_width=bandmm.cyclic_bandwidth(a),
                                       block=125, cyclic=True)
    if int(outl.nnz):
        raise AssertionError("torus30 must be fully cyclic-banded")
    p_band = dband.shard_band(band, mesh=mesh)
    a_limbs = bandmm.limbs_for_max(float(jax.device_get(band.max_value())))
    for step in (2, 3, 4):
        t0 = time.perf_counter()
        flops = np.asarray(jax.device_get(
            dist.symbolic_flops_sharded(s_esc, a, mesh=mesh)))
        cap = 1 << (max(int(flops.max()), 1) - 1).bit_length()
        s_esc = dist.spgemm_sharded(s_esc, a, expand_cap=cap, mesh=mesh)
        csr_equal(dist.unshard(s_esc).to_numpy(), want[step],
                  f"sharded ESC A^{step}")
        t_esc = time.perf_counter() - t0

        t0 = time.perf_counter()
        s_ring = panels.spgemm_panels_auto(s_ring, s_a, mesh=mesh)
        csr_equal(dist.unshard(s_ring).to_numpy(), want[step],
                  f"ring panels A^{step}")
        t_ring = time.perf_counter() - t0

        t0 = time.perf_counter()
        p_limbs = bandmm.limbs_for_max(
            float(jax.device_get(p_band.max_value())))
        p_band = dband.band_matmul_sharded(p_band, band, p_limbs=p_limbs,
                                           a_limbs=a_limbs, mesh=mesh)
        csr_equal(bandmm.band_to_csr(p_band).to_numpy(), want[step],
                  f"sharded band A^{step}")
        t_band = time.perf_counter() - t0
        print(f"  A^{step} nnz={int(want[step][0][-1])}: ESC {t_esc:.2f} s "
              f"devices {devices_of(s_esc.col_idx)}; ring {t_ring:.2f} s "
              f"devices {devices_of(s_ring.col_idx)}; band {t_band:.2f} s "
              f"devices {devices_of(p_band.data)} (first-call wall, incl. "
              f"checks) [{card}]", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the row-sharded dist/ paths on 4 cards")
    args = ap.parse_args(argv)

    import jax

    from sparsetpu.bench import configure_cache
    from sparsetpu.bench.device import card_name_power, require_gpu

    with phase("device"):
        cache = configure_cache()  # before the first compile
        device = require_gpu()
        cards = card_name_power()
        card = cards.splitlines()[0]  # the label for timings
        print(f"  card: {card} (x{len(cards.splitlines())})")
        print(f"  device_kind: {device['kind']}; devices: {device['count']}; "
              f"jax {jax.__version__}; compile cache: {cache}", flush=True)
    if args.chips == 4:
        with phase("dist4"):
            phase_dist4(card)
    else:
        with phase("chain"):
            phase_chain(card)
        with phase("spgemm"):
            phase_spgemm()
        with phase("attention"):
            phase_attention()
        with phase("graphs"):
            phase_graphs()
        with phase("einsum"):
            phase_einsum()
        with phase("kernels"):
            phase_kernels(card)
    print(cards)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
