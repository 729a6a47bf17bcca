"""Synthetic conformer molecules, after ``tsdiff_tpu_torch/data/synthetic.py``
(``make_molecule``), with the heavy atoms set by the traffic's ``heavy``:
``min(max, ceil(share * n))`` heavy atoms of ``types`` drawn with
``shares``, in a tree (1.5 A bonds, 1 in 5 double), and hydrogens on them
(1.09 A) for the rest of the ``n`` atoms."""

from __future__ import annotations

import math

import numpy as np

from portbench.corpus import sparse


def _place(rng: np.random.Generator, pos: np.ndarray, anchor: int, length: float) -> np.ndarray:
    best, best_gap = None, -1.0
    for _ in range(20):
        v = rng.normal(size=3)
        p = pos[anchor] + length * v / np.linalg.norm(v)
        gap = float(np.min(np.linalg.norm(pos - p, axis=1)))
        if gap > best_gap:
            best, best_gap = p, gap
    return best


def make(rng: np.random.Generator, n: int, index: int, traffic: dict) -> dict:
    heavy_spec = traffic["heavy"]
    h = max(1, min(heavy_spec["max"], math.ceil(heavy_spec["share"] * n)))
    heavy = rng.choice(heavy_spec["types"], size=h, p=heavy_spec["shares"])
    n_h = np.full(h, (n - h) // h)
    n_h[rng.permutation(h)[: (n - h) % h]] += 1
    types = np.concatenate([heavy, np.ones(n - h, np.int64)]).astype(np.int32)
    pos = np.zeros((n, 3))
    bonds = []
    for i in range(1, h):
        j = int(rng.integers(0, i))
        pos[i] = _place(rng, pos[:i], j, 1.5)
        bonds.append((j, i, 2 if rng.random() < 0.2 else 1))
    k = h
    for i in range(h):
        for _ in range(int(n_h[i])):
            pos[k] = _place(rng, pos[:k], i, 1.09)
            bonds.append((i, k, 1))
            k += 1
    bm = np.zeros((n, n), np.int64)
    for a, b, code in bonds:
        bm[a, b] = bm[b, a] = code
    edge_index, edge_type = sparse(bm)
    return dict(atom_type=types, r_feat=np.zeros((n, 0), np.float32),
                p_feat=np.zeros((n, 0), np.float32),
                pos=(pos - pos.mean(axis=0)).astype(np.float32),
                edge_index=edge_index, edge_type=edge_type,
                smiles=f"synthetic-conformer-{index}-{n}")
