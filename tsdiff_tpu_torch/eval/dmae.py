"""D-MAE — the TS-accuracy metric: mean absolute difference of the
strict-upper-triangle interatomic distance matrices of two conformations,
minimised over the automorphisms of the typed condensed reaction graph, so
that symmetric atoms (the three H of a methyl group, the carbons of a ring)
are matched optimally.  Automorphisms come from a pure-numpy backtracking
search over the condensed bond matrix (no RDKit).  The identity is always
one of them, so ``calc_dmae`` without a mapping is an upper bound of
``dmae_for_graph``."""

from __future__ import annotations

import numpy as np


def distance_matrix(pos: np.ndarray) -> np.ndarray:
    return np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)


def calc_dmae(pos_ref: np.ndarray, pos_gen: np.ndarray, mapping=None) -> float:
    """Mean |d_ref - d_gen| over the strict upper triangle; ``mapping``
    permutes pos_gen."""
    d_ref = distance_matrix(pos_ref)
    pg = pos_gen[np.asarray(mapping)] if mapping is not None else pos_gen
    d_gen = distance_matrix(pg)
    iu = np.triu_indices(len(pos_ref), k=1)
    return float(np.abs(d_ref[iu] - d_gen[iu]).mean())


def graph_automorphisms(
    bond_mat: np.ndarray, atom_type: np.ndarray, max_perms: int = 10000
) -> list[np.ndarray]:
    """Automorphisms of the typed condensed reaction graph: the permutations
    ``perm`` with ``atom_type[perm] == atom_type`` and
    ``bond_mat[perm][:, perm] == bond_mat``, at most ``max_perms`` of them.
    Backtracking over the nodes in order; a node's candidates are the nodes
    with its atom type and the same multiset of incident condensed bond
    types."""
    n = len(atom_type)
    invariants = []
    for i in range(n):
        inc = tuple(sorted(bond_mat[i][bond_mat[i] > 0]))
        invariants.append((int(atom_type[i]), inc))
    candidates = [[j for j in range(n) if invariants[j] == invariants[i]] for i in range(n)]

    autos: list[np.ndarray] = []
    perm = np.full(n, -1, dtype=np.int64)
    used = np.zeros(n, dtype=bool)

    def backtrack(i: int):
        if len(autos) >= max_perms:
            return
        if i == n:
            autos.append(perm.copy())
            return
        for j in candidates[i]:
            if used[j]:
                continue
            if all(bond_mat[i, k] == bond_mat[j, perm[k]] for k in range(i)):
                perm[i] = j
                used[j] = True
                backtrack(i + 1)
                used[j] = False
                perm[i] = -1

    backtrack(0)
    return autos


def get_min_dmae_match(
    pos_ref: np.ndarray, pos_gen: np.ndarray, matches: list[np.ndarray]
) -> tuple[float, np.ndarray]:
    """``(D-MAE, mapping)`` of the match with the least D-MAE; the first such
    match on a tie, ``(inf, None)`` for no match."""
    best = (float("inf"), None)
    for m in matches:
        v = calc_dmae(pos_ref, pos_gen, mapping=m)
        if v < best[0]:
            best = (v, m)
    return best


def dmae_for_graph(graph: dict, pos_gen: np.ndarray, use_automorphisms: bool = True) -> float:
    """D-MAE of a generated geometry against a dataset graph's reference TS,
    under the best automorphism match.  The graph carries ``atom_type``,
    ``pos`` and either the dense ``bond_mat`` or ``edge_index`` with
    ``edge_type``."""
    n = int(graph["atom_type"].shape[0])
    pos_ref = np.asarray(graph["pos"])[:n]
    pos_gen = np.asarray(pos_gen)[:n]
    if not use_automorphisms:
        return calc_dmae(pos_ref, pos_gen)
    if "bond_mat" in graph:
        bond = np.asarray(graph["bond_mat"], dtype=np.int64)[:n, :n]
    else:
        bond = np.zeros((n, n), dtype=np.int64)
        ei = np.asarray(graph["edge_index"])
        bond[ei[0], ei[1]] = np.asarray(graph["edge_type"])
    autos = graph_automorphisms(bond, np.asarray(graph["atom_type"]))
    val, _ = get_min_dmae_match(pos_ref, pos_gen, autos)
    return val
