"""Block-sparse matrices and the sampled dense-dense (SDD) score blocks.

Re-design of the reference's Chunked/Blocked block-sparse tensors and
their AVX2 `C += A.B^T` microkernels (src/chunked.rs:12-131, :315-368;
linalg/src/blocked.rs): blocks become dense tiles, the block map becomes a
packed index list, and only *present* blocks are computed — absent blocks
cost nothing, which is the entire point of the format.

  - ``sdd_block_scores``: sampled dense-dense C[blk] = Q[qi] @ K[ki]^T for
    a list of (qi, ki) block pairs — the block-sparse attention primitive.
    The listed Q and K blocks are gathered and multiplied in one batched
    matmul (cuBLAS on a GPU); the gathered blocks are small next to the
    scores they produce.
  - ``BlockSparseMatrix``: packed block storage with to/from dense.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["blocks", "block_rows", "block_cols"],
    meta_fields=["shape", "block_shape"],
)
@dataclasses.dataclass(frozen=True)
class BlockSparseMatrix:
    """Packed block-sparse matrix: only present blocks are stored.

    blocks:      f32[nblocks, bm, bn] dense tiles
    block_rows:  i32[nblocks] block-row of each tile
    block_cols:  i32[nblocks] block-col of each tile
    """

    blocks: jnp.ndarray
    block_rows: jnp.ndarray
    block_cols: jnp.ndarray
    shape: Tuple[int, int]
    block_shape: Tuple[int, int]

    @property
    def nblocks(self) -> int:
        return self.blocks.shape[0]

    def density(self) -> float:
        bm, bn = self.block_shape
        total = (self.shape[0] // bm) * (self.shape[1] // bn)
        return self.nblocks / max(total, 1)

    def memory_bytes(self) -> int:
        """Self-reported storage (reference estimate_memory_usage,
        src/chunked.rs:166-170)."""
        return int(self.blocks.size * 4 + self.nblocks * 8)

    def to_dense(self) -> jnp.ndarray:
        bm, bn = self.block_shape
        m, n = self.shape
        out = jnp.zeros((m // bm, n // bn, bm, bn), jnp.float32)
        out = out.at[self.block_rows, self.block_cols].add(self.blocks)
        return out.transpose(0, 2, 1, 3).reshape(m, n)

    @staticmethod
    def from_dense(x, block_shape=(128, 128)) -> "BlockSparseMatrix":
        x = np.asarray(x, np.float32)
        m, n = x.shape
        bm, bn = block_shape
        assert m % bm == 0 and n % bn == 0, (x.shape, block_shape)
        tiles = x.reshape(m // bm, bm, n // bn, bn).transpose(0, 2, 1, 3)
        present = np.argwhere(np.abs(tiles).sum(axis=(2, 3)) > 0)
        if len(present) == 0:
            present = np.zeros((1, 2), np.int64)
            blocks = np.zeros((1, bm, bn), np.float32)
        else:
            blocks = tiles[present[:, 0], present[:, 1]]
        return BlockSparseMatrix(
            blocks=jnp.asarray(blocks),
            block_rows=jnp.asarray(present[:, 0], jnp.int32),
            block_cols=jnp.asarray(present[:, 1], jnp.int32),
            shape=(m, n),
            block_shape=block_shape,
        )


@partial(jax.jit, static_argnames=("block_m", "block_n"))
def sdd_block_scores(
    q: jnp.ndarray,
    k: jnp.ndarray,
    qi: jnp.ndarray,
    ki: jnp.ndarray,
    block_m: int = 128,
    block_n: int = 128,
) -> jnp.ndarray:
    """Compute C blocks C[t] = Q[qi[t]*bm : +bm] @ K[ki[t]*bn : +bn]^T.

    q: f32[M, D], k: f32[N, D]; qi/ki: i32[T] block indices.  Returns
    f32[T, bm, bn] packed score blocks.  precision=HIGHEST keeps full f32
    products (an f32 matmul may otherwise run in TF32 on a GPU, too loose
    for the reference's 1e-4 rel-err agreement, src/main.rs:100-114)."""
    m, d = q.shape
    n, _ = k.shape
    qb = q.reshape(m // block_m, block_m, d)[qi]
    kb = k.reshape(n // block_n, block_n, d)[ki]
    return jnp.einsum("tmd,tnd->tmn", qb, kb,
                      precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=jnp.float32)


def block_sparse_attention_scores(
    q4: np.ndarray,
    k4: np.ndarray,
    block: int = 128,
):
    """Reference block-sparse attention (bhqd,bhkd->bhqk) on dense tiles.

    Flattens (b, s, h) -> rows, pads to the tile size, builds the
    block-diagonal group mask intersected with Q/K block occupancy, and
    computes only those score blocks with :func:`sdd_block_scores`.

    Returns (packed_blocks, qi, ki, meta) — use
    :func:`scores_blocks_to_dense` to materialize for verification.
    """
    b, s, h, d = q4.shape
    g = b * s
    rows = g * h
    pad_rows = -(-rows // block) * block
    dpad = -(-d // 8) * 8

    def flat(x):
        xf = np.zeros((pad_rows, dpad), np.float32)
        xf[:rows, :d] = np.asarray(x, np.float32).reshape(rows, d)
        return xf

    qf, kf = flat(q4), flat(k4)
    # block occupancy
    nb = pad_rows // block
    occ_q = np.abs(qf).reshape(nb, block, dpad).sum(axis=(1, 2)) > 0
    occ_k = np.abs(kf).reshape(nb, block, dpad).sum(axis=(1, 2)) > 0
    # group-diagonal pairs: score block (i, j) needed iff some group's rows
    # land in both block i and block j
    starts = np.arange(g) * h
    ends = starts + h - 1
    gi0, gi1 = starts // block, ends // block
    pairs = set()
    for a0, a1 in zip(gi0, gi1):
        for bi in range(a0, a1 + 1):
            for bj in range(a0, a1 + 1):
                pairs.add((bi, bj))
    pairs = sorted(pairs)
    pairs = [(i, j) for (i, j) in pairs if occ_q[i] and occ_k[j]]
    if not pairs:
        pairs = [(0, 0)]
    qi = jnp.asarray([p[0] for p in pairs], jnp.int32)
    ki = jnp.asarray([p[1] for p in pairs], jnp.int32)
    blocks = sdd_block_scores(
        jnp.asarray(qf), jnp.asarray(kf), qi, ki, block_m=block, block_n=block
    )
    meta = dict(shape4=(b, s, h, d), block=block, pad_rows=pad_rows,
                qf=jnp.asarray(qf), kf=jnp.asarray(kf))
    return blocks, qi, ki, meta


def scores_blocks_to_dense(blocks, qi, ki, meta) -> np.ndarray:
    """Packed score blocks -> (b, s, h, h) dense numpy (group-diagonal
    entries only; cross-group tile regions are discarded)."""
    b, s, h, d = meta["shape4"]
    block = meta["block"]
    pad = meta["pad_rows"]
    full = np.zeros((pad, pad), np.float32)
    blocks = np.asarray(jax.device_get(blocks))
    for t, (i, j) in enumerate(zip(np.asarray(qi), np.asarray(ki))):
        full[i * block:(i + 1) * block, j * block:(j + 1) * block] = blocks[t]
    g = b * s
    out = np.zeros((g, h, h), np.float32)
    for gg in range(g):
        r0 = gg * h
        out[gg] = full[r0:r0 + h, r0:r0 + h]
    return out.reshape(b, s, h, h)
