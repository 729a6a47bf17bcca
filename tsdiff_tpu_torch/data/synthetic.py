"""Synthetic reaction corpus with a learnable graph -> geometry mapping.

Each reaction is a bent-chain molecule whose bend at atom i is a fixed
function of the (atom_type[i-1], atom_type[i]) pair, through a random table
drawn once from seed 7.  Sizes follow a discretized normal (mean 14, sigma
3.5, clipped to 6..23 atoms).  The reactant carries a ring-closure bond that
the product breaks; r_feat/p_feat are degree/type one-hots at feat_dim 25.
The trained checkpoints under ``artifacts/seeds/ckpts`` were trained on a
corpus drawn this way, so it serves as an unseen test set for them.
"""

from __future__ import annotations

import numpy as np

from tsdiff_tpu_torch.chem import NUM_BOND_TYPES

FEAT_DIM = 25
N_TYPES = 8  # atom types 1..8


def _bend_table(seed: int = 7) -> np.ndarray:
    """(9, 9, 3) fixed per-type-pair direction updates."""
    rng = np.random.default_rng(seed)
    return rng.normal(scale=0.45, size=(N_TYPES + 1, N_TYPES + 1, 3))


def make_reaction(rng: np.random.Generator, table: np.ndarray) -> dict:
    n = int(np.clip(round(rng.normal(14.0, 3.5)), 6, 23))
    types = rng.integers(1, N_TYPES + 1, size=n).astype(np.int32)

    pos = np.zeros((n, 3), np.float32)
    direction = np.array([1.0, 0.0, 0.0])
    for i in range(1, n):
        direction = direction + table[types[i - 1], types[i]]
        direction = direction / np.linalg.norm(direction)
        pos[i] = pos[i - 1] + 1.5 * direction
    pos -= pos.mean(axis=0)

    # chain bonds in both R and P; a ring-closure bond 0-j present in R only
    bm = np.zeros((n, n), np.int64)
    single_single = 1 * NUM_BOND_TYPES + 1
    for i in range(n - 1):
        bm[i, i + 1] = bm[i + 1, i] = single_single
    j = int(rng.integers(3, n))
    bm[0, j] = bm[j, 0] = 1 * NUM_BOND_TYPES + 0

    # [type one-hot (8) | degree one-hot (4) | pad | in-ring flag | pad]
    def feats(side: str) -> np.ndarray:
        f = np.zeros((n, FEAT_DIM), np.float32)
        f[np.arange(n), types - 1] = 1.0
        r_code = bm // NUM_BOND_TYPES
        p_code = bm % NUM_BOND_TYPES
        adj = (r_code > 0) if side == "r" else (p_code > 0)
        deg = np.clip(adj.sum(1), 0, 3)
        f[np.arange(n), 8 + deg] = 1.0
        if side == "r":
            f[0, 16] = f[j, 16] = 1.0
        return f

    return dict(
        atom_type=types,
        r_feat=feats("r"),
        p_feat=feats("p"),
        pos=pos.astype(np.float32),
        bond_mat=bm,
        smiles=f"synthetic-{n}-{j}",
    )


def make_corpus(count: int, seed: int) -> list[dict]:
    """``count`` reactions from ``np.random.default_rng(seed)``."""
    table = _bend_table()
    rng = np.random.default_rng(seed)
    return [make_reaction(rng, table) for _ in range(count)]


def sparse_edges(graphs: list[dict]) -> list[dict]:
    """The graphs in the on-disk form of featurized and converted datasets:
    ``bond_mat`` replaced by ``edge_index (2, E)`` int32 and ``edge_type
    (E,)`` int32 over its nonzero entries, in row-major order."""
    out = []
    for g in graphs:
        g = dict(g)
        bm = np.asarray(g.pop("bond_mat"))
        row, col = np.nonzero(bm)
        g["edge_index"] = np.stack([row, col]).astype(np.int32)
        g["edge_type"] = bm[row, col].astype(np.int32)
        out.append(g)
    return out


#: heavy-atom types of the conformer corpus and their shares: C, N, O
CONFORMER_HEAVY_TYPES = (6, 7, 8)
CONFORMER_HEAVY_SHARES = (0.7, 0.15, 0.15)


def _place(rng: np.random.Generator, pos: np.ndarray, anchor: int, length: float) -> np.ndarray:
    """A point ``length`` from atom ``anchor`` in a random direction, the one
    of 20 tries farthest from every placed atom."""
    best, best_gap = None, -1.0
    for _ in range(20):
        v = rng.normal(size=3)
        p = pos[anchor] + length * v / np.linalg.norm(v)
        gap = float(np.min(np.linalg.norm(pos - p, axis=1)))
        if gap > best_gap:
            best, best_gap = p, gap
    return best


def make_molecule(rng: np.random.Generator, index: int) -> dict:
    """One synthetic molecule of 9 to 29 atoms in the legacy graph schema:
    a tree of ceil(n / 3) heavy atoms (C, N, O; 1.5 A bonds, 1 in 5 of them
    double) with 0 to 2 hydrogens each (atom type 1, 1.09 A), and its
    geometry."""
    n = int(rng.integers(9, 30))
    h = -(-n // 3)
    heavy = rng.choice(CONFORMER_HEAVY_TYPES, size=h, p=CONFORMER_HEAVY_SHARES)
    n_h = np.full(h, (n - h) // h)
    n_h[rng.permutation(h)[: (n - h) % h]] += 1     # n - h <= 2h hydrogens
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
    row = [a for a, b, _ in bonds] + [b for a, b, _ in bonds]
    col = [b for a, b, _ in bonds] + [a for a, b, _ in bonds]
    code = [c for *_, c in bonds] * 2
    order = np.argsort(np.asarray(row) * n + np.asarray(col), kind="stable")
    return dict(
        atom_type=types,
        r_feat=np.zeros((n, 0), np.float32),
        p_feat=np.zeros((n, 0), np.float32),
        pos=(pos - pos.mean(axis=0)).astype(np.float32),
        edge_index=np.stack([np.asarray(row)[order], np.asarray(col)[order]]).astype(np.int32),
        edge_type=np.asarray(code, np.int32)[order],
        smiles=f"synthetic-conformer-{index}-{n}",
    )


def conformers_of(rng: np.random.Generator, mol: dict, k: int, scale: float = 0.15) -> list[dict]:
    """``k`` conformers of ``mol``: its geometry moved by N(0, ``scale``)
    per coordinate, rotated at random and centred."""
    out = []
    for _ in range(k):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        p = (np.asarray(mol["pos"], np.float64) + rng.normal(scale=scale, size=mol["pos"].shape)) @ q
        g = dict(mol)
        g["pos"] = (p - p.mean(axis=0)).astype(np.float32)
        out.append(g)
    return out


def make_conformer_corpus(n_molecules: int, seed: int, conformers: int = 5) -> list[dict]:
    """GeoDiff-legacy conformer graphs from ``np.random.default_rng(seed)``:
    ``conformers`` graphs per molecule, sharing its ``smiles``, in the
    schema of ``data/legacy.py`` (zero-width ``r_feat``/``p_feat``, plain
    bond codes as sparse ``edge_index``/``edge_type``).  Test data: the
    GEOM pickles and RDKit are not in the repository."""
    rng = np.random.default_rng(seed)
    graphs = []
    for i in range(n_molecules):
        graphs.extend(conformers_of(rng, make_molecule(rng, i), conformers))
    return graphs
