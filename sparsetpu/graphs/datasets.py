"""Real-graph loading + skewed-degree synthetic generators.

The reference benches real graphs from ``gen-graphs/*.edges`` files fetched
externally with torch_geometric/ogb (src/graph_csr.rs:1209-1224,
requirements.txt).  This environment has no network egress, so:

  - :func:`load_edges` reads the same whitespace ``src dst`` edge-file
    format when files are present;
  - :func:`power_law` generates Barabási–Albert-style preferential-
    attachment graphs as the skewed-degree stress workload (BASELINE
    config 4 — MAGNUS-categorization stress), with degree skew comparable
    to citation graphs.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from .generate import Coo, _dedup_coo


def load_edges(path: str, undirected: bool = False) -> Coo:
    """Read a ``src dst`` edge list file (one edge per line, '#' comments)."""
    src, dst = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            a, b = line.split()[:2]
            src.append(int(a))
            dst.append(int(b))
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    n = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
    if undirected:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    return _dedup_coo(n, src, dst, np.ones(len(src), np.uint64))


def power_law(n: int, m_per_node: int = 3, seed: int = 0,
              target_directed_edges: Optional[int] = None) -> Coo:
    """Preferential-attachment (Barabási–Albert) multigraph, undirected.

    Degree distribution ~ k^-3: a few huge-degree hubs + a long tail, the
    row-cost skew that stresses per-row kernel categorization.
    Vectorized approximate BA: each new node attaches to m endpoints
    sampled from the current edge-endpoint pool (preferential by degree).

    ``target_directed_edges``: aim the total stored (directed) entry count
    at this value by fractional per-node attachment — each undirected
    attachment stores two directed entries, so integer ``m_per_node``
    alone quantizes the density to multiples of 2n (substitutes would run
    at 2x the published edge counts; see PUBLISHED_STATS /
    check_substitute)."""
    assert n > m_per_node >= 1
    rng = np.random.default_rng(seed)
    if target_directed_edges is not None:
        t = target_directed_edges / 2.0 / max(n - m_per_node - 1, 1)
        base = max(1, int(t))
        frac = max(0.0, min(1.0, t - base))
        m_of = base + (rng.random(n) < frac).astype(np.int64)
    else:
        m_of = np.full(n, m_per_node, np.int64)
    m0 = m_per_node
    # seed clique endpoints
    pool = [i for i in range(m0 + 1) for _ in range(m0)]
    src_list = []
    dst_list = []
    for v in range(m0 + 1, n):
        targets = rng.choice(len(pool), size=int(m_of[v]))
        ts = {pool[t] for t in targets}
        for t in ts:
            src_list.append(v)
            dst_list.append(t)
            pool.append(t)
            pool.append(v)
    src = np.asarray(src_list, np.int64)
    dst = np.asarray(dst_list, np.int64)
    rows = np.concatenate([src, dst])
    cols = np.concatenate([dst, src])
    return _dedup_coo(n, rows, cols, np.ones(len(rows), np.uint64))


def degree_stats(coo: Coo) -> Tuple[int, float]:
    rows, _, _, n = coo
    deg = np.bincount(rows, minlength=n)
    return int(deg.max()), float(deg.mean())


# Published degree structure of the graphs the reference benches
# (src/graph_csr.rs:1209-1224).  No network egress here, so the numbers are
# the datasets' published stats: Planetoid cora/nell node+edge counts and
# ogb's ogbn-arxiv counts; ``min_max_deg`` is a lower bound on the hub
# degree (cora's published max degree is 168; nell and arxiv are
# hub-dominated knowledge/citation graphs with max degrees in the
# hundreds/thousands).  ``check_substitute`` asserts the power-law
# substitutes reproduce these moments so "real-graph scale" claims rest on
# matched degree structure, not just a node count.
PUBLISHED_STATS = {
    #  name:        (n,      directed_edges, min_max_deg)
    "cora":        (2708,    10556,          60),
    "nell":        (65755,   251550,         300),
    "ogbn_arxiv":  (169343,  1166243,        1000),
}


def check_substitute(name: str, coo: Coo,
                     edge_tol: float = 0.05) -> dict:
    """Assert a synthetic stand-in matches the named real graph's published
    degree moments: exact node count, directed-edge count within
    ``edge_tol``, mean degree within the same band, and a hub tail at the
    published order (max degree >= the published floor and >= 10x mean).
    Returns the measured stats dict for logging."""
    n_pub, e_pub, min_max = PUBLISHED_STATS[name]
    rows, _, _, n = coo
    assert n == n_pub, f"{name}: n={n} != published {n_pub}"
    deg = np.bincount(rows, minlength=n)
    e = len(rows)
    mean = float(deg.mean())
    mean_pub = e_pub / n_pub
    assert abs(e - e_pub) <= edge_tol * e_pub, \
        f"{name}: edges={e} vs published {e_pub} (tol {edge_tol:.0%})"
    assert abs(mean - mean_pub) <= edge_tol * mean_pub, \
        f"{name}: mean degree {mean:.2f} vs published {mean_pub:.2f}"
    mx = int(deg.max())
    assert mx >= min_max and mx >= 10 * mean, \
        f"{name}: max degree {mx} lacks the published hub tail " \
        f"(floor {min_max}, mean {mean:.2f})"
    return dict(name=name, n=n, edges=e, mean_deg=mean, max_deg=mx,
                p99_deg=float(np.percentile(deg, 99)))
