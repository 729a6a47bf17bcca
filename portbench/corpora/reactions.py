"""Synthetic reactions, copied from ``tsdiff_tpu_torch/data/synthetic.py``
(``make_reaction``) so that a later change to the program cannot move the
yardstick: a bent chain of ``n`` atoms whose bends follow its atom types,
with a ring-closure bond in the reactant that the product breaks."""

from __future__ import annotations

import functools

import numpy as np

from portbench.corpus import NUM_BOND_TYPES, sparse

FEAT_DIM = 25
N_TYPES = 8


@functools.lru_cache(maxsize=1)
def _bend_table(seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(scale=0.45, size=(N_TYPES + 1, N_TYPES + 1, 3))


def make(rng: np.random.Generator, n: int, index: int, traffic: dict) -> dict:
    table = _bend_table()
    types = rng.integers(1, N_TYPES + 1, size=n).astype(np.int32)
    pos = np.zeros((n, 3), np.float32)
    direction = np.array([1.0, 0.0, 0.0])
    for i in range(1, n):
        direction = direction + table[types[i - 1], types[i]]
        direction = direction / np.linalg.norm(direction)
        pos[i] = pos[i - 1] + 1.5 * direction
    pos -= pos.mean(axis=0)
    bm = np.zeros((n, n), np.int64)
    for i in range(n - 1):
        bm[i, i + 1] = bm[i + 1, i] = 1 * NUM_BOND_TYPES + 1
    j = int(rng.integers(3, n))
    bm[0, j] = bm[j, 0] = 1 * NUM_BOND_TYPES + 0

    def feats(side: str) -> np.ndarray:
        f = np.zeros((n, FEAT_DIM), np.float32)
        f[np.arange(n), types - 1] = 1.0
        adj = (bm // NUM_BOND_TYPES > 0) if side == "r" else (bm % NUM_BOND_TYPES > 0)
        f[np.arange(n), 8 + np.clip(adj.sum(1), 0, 3)] = 1.0
        if side == "r":
            f[0, 16] = f[j, 16] = 1.0
        return f

    edge_index, edge_type = sparse(bm)
    return dict(atom_type=types, r_feat=feats("r"), p_feat=feats("p"),
                pos=pos.astype(np.float32), edge_index=edge_index, edge_type=edge_type,
                smiles=f"synthetic-{index}-{n}-{j}")
