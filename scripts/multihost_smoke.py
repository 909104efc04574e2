"""2-process localhost smoke worker for dist/multihost.py.

Launched (twice, with process ids 0 and 1) by tests/test_multihost.py::
test_two_process_localhost_smoke — the one code path that cannot run inside
a single pytest process: ``jax.distributed.initialize(coordinator_address=
localhost:<port>, num_processes=2)`` on the CPU backend, 2 virtual devices
per process, pod_mesh over all 4, then a row-sharded ESC SpGEMM whose local
shards are checked bit-exact against the host oracle.

Usage: python scripts/multihost_smoke.py <pid> <nproc> <port>
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
# pin the CPU platform via jax.config like tests/conftest.py, before any
# backend initialization
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["SPARSETPU_COORD"] = f"localhost:{port}"
os.environ["SPARSETPU_NPROC"] = str(nproc)
os.environ["SPARSETPU_PID"] = str(pid)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from sparsetpu.bench import configure_cache  # noqa: E402

configure_cache()

import numpy as np  # noqa: E402

from sparsetpu import SparseCSR, U64  # noqa: E402
from sparsetpu.dist import multihost, shard as dist  # noqa: E402
from sparsetpu.graphs import generate  # noqa: E402
from sparsetpu.utils import oracle  # noqa: E402


def main():
    multihost.initialize()
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.process_index() == pid, jax.process_index()
    nd = jax.device_count()
    assert nd == 2 * nproc, nd

    mesh = multihost.pod_mesh()

    # identical host-side graph on every process (fixed seed)
    rows, cols, vals, n = generate.thin(
        generate.lattice([4, 4, 4], torus=True), 0.3, seed=7
    )
    a = SparseCSR.from_coo_host(rows, cols, vals, n, sr=U64)

    # host oracle product + exact per-shard flops for the static caps
    amap = {(int(r), int(c)): int(v) for r, c, v in zip(rows, cols, vals)}
    want = oracle.to_dense(oracle.matmul(amap, amap), n)
    rp_host = np.asarray(jax.device_get(a.row_ptr))
    row_nnz = np.diff(rp_host)
    ci_host = np.asarray(jax.device_get(a.col_idx))[: int(a.nnz)]
    flops_of_row = np.zeros(n, np.int64)
    for r in range(n):
        s, e = rp_host[r], rp_host[r + 1]
        flops_of_row[r] = row_nnz[ci_host[s:e]].sum()
    n_local = -(-n // nd)
    shard_flops = max(
        int(flops_of_row[d * n_local:(d + 1) * n_local].sum())
        for d in range(nd)
    )
    cap = 1 << (max(shard_flops, 1) - 1).bit_length()

    s = dist.shard(a, nd, mesh=mesh)
    start, stop = multihost.host_row_block(n)
    assert (stop - start) == 2 * n_local, (start, stop, n_local)

    c = dist.spgemm_sharded(s, a, expand_cap=cap, mesh=mesh)

    # collect this process's local shards and check them against the oracle
    by_dev = {}
    for arr_name in ("row_ptr", "col_idx", "nnz"):
        for sh in getattr(c, arr_name).addressable_shards:
            by_dev.setdefault(sh.device, {})[arr_name] = np.asarray(sh.data)
    for li, limb in enumerate(c.values):
        for sh in limb.addressable_shards:
            by_dev[sh.device][f"limb{li}"] = np.asarray(sh.data)
    dev_block = {
        sh.device: sh.index[0].start or 0
        for sh in c.row_ptr.addressable_shards
    }
    checked = 0
    for dev, arrs in by_dev.items():
        d = dev_block[dev]
        k = int(arrs["nnz"][0])
        assert k >= 0, "shard capacity overflow"
        rp = arrs["row_ptr"][0]
        got = np.zeros((c.n_local, n), np.uint64)
        lr = np.repeat(np.arange(c.n_local), np.diff(rp))[:k]
        got[lr, arrs["col_idx"][0][:k]] = (
            arrs["limb0"][0][:k].astype(np.uint64)
            + (arrs["limb1"][0][:k].astype(np.uint64) << np.uint64(32))
        )
        r0 = d * c.n_local
        block = np.zeros((c.n_local, n), np.uint64)
        rows_here = want[r0: r0 + c.n_local]
        block[: rows_here.shape[0]] = rows_here
        assert np.array_equal(got, block), f"shard at rows {r0} disagrees"
        checked += 1
    print(f"MULTIHOST_OK pid={pid} devices={nd} shards_checked={checked} "
          f"nnz_total={int(np.count_nonzero(want))}", flush=True)


if __name__ == "__main__":
    main()
