"""Hierarchical clustering of the generated conformers of one reaction.

Single linkage under an automorphism-aware distance-matrix metric:

    d(u, v) = min over graph automorphisms m of
              sqrt(mean((pdist(u) - pdist(v[m]))^2))

The automorphisms come from RDKit substructure self-matches of the reaction
SMARTS, intersected between reactants and products, where RDKit is
installed, or from the graph search of ``eval/dmae.py`` on a graph dict.
Alignment for export is the numpy Kabsch with mirror of ``eval/align.py``.
scipy is imported by the functions that need it.
"""

from __future__ import annotations

import numpy as np

from tsdiff_tpu_torch.eval.align import rotate_transform_mirror
from tsdiff_tpu_torch.eval.dmae import graph_automorphisms


def get_substruct_matches(smarts: str) -> list[tuple[int, ...]]:
    """RDKit substructure self-matches of the reactant and product sides,
    intersected, in atom-map order.  Needs RDKit."""
    from rdkit import Chem

    def side_matches(s):
        mol = Chem.MolFromSmarts(s)
        matches = list(mol.GetSubstructMatches(mol, uniquify=False))
        amap = np.array([a.GetAtomMapNum() for a in mol.GetAtoms()]) - 1
        inv = np.argsort(amap)
        return {tuple(amap[np.array(m)[inv]]) for m in matches}

    r, p = smarts.split(">>")
    matches = sorted(side_matches(r) & side_matches(p))
    return [tuple(int(i) for i in m) for m in matches]


def matches_for(graph_or_smarts) -> list:
    """Automorphism matches: through RDKit for a SMARTS string, by graph
    search for a graph dict (``edge_index``/``edge_type``)."""
    if isinstance(graph_or_smarts, str):
        return get_substruct_matches(graph_or_smarts)
    g = graph_or_smarts
    n = int(g["atom_type"].shape[0])
    bond = np.zeros((n, n), dtype=np.int64)
    ei = np.asarray(g["edge_index"])
    bond[ei[0], ei[1]] = np.asarray(g["edge_type"])
    return [tuple(int(x) for x in m) for m in graph_automorphisms(bond, g["atom_type"])]


def pairwise_metric(u: np.ndarray, v: np.ndarray, matches) -> float:
    """Smallest RMS difference of the condensed distance vectors of ``u``
    and ``v`` over the matches."""
    from scipy.spatial.distance import pdist

    du = pdist(u)
    best = np.inf
    for m in matches:
        dv = pdist(v[list(m)])
        val = np.sqrt(((du - dv) ** 2).mean())
        if val < best:
            best = val
    return float(best)


def cluster_conformers(pos_list: list[np.ndarray], matches, thresh: float = 0.10) -> dict:
    """Single-linkage clustering under ``pairwise_metric``, cut at distance
    ``thresh``.  Returns ``{"clusters": (n,) labels from 1,
    "num_clusters", "linkage", "dist_mat"}``."""
    from scipy.cluster.hierarchy import fcluster, linkage

    n = len(pos_list)
    flat = np.array([p.reshape(-1) for p in pos_list])

    def f(u, v):
        return pairwise_metric(u.reshape(-1, 3), v.reshape(-1, 3), matches)

    lk = linkage(flat, "single", optimal_ordering=True, metric=f)
    clusters = fcluster(lk, t=thresh, criterion="distance")
    dist = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            dist[i, j] = dist[j, i] = f(flat[i], flat[j])
    return {
        "clusters": clusters,
        "num_clusters": int(clusters.max()),
        "linkage": lk,
        "dist_mat": dist,
    }


def align_cluster(pos_list: list[np.ndarray], matches,
                  ref: np.ndarray | None = None) -> list[np.ndarray]:
    """Each conformer renumbered by its best match (smallest D-MAE to
    ``ref``), then rigidly aligned to ``ref`` with the mirror tried."""
    from scipy.spatial.distance import cdist

    if ref is None:
        ref = pos_list[0]
    out = []
    d_ref = cdist(ref, ref)
    n = len(ref)
    for p in pos_list:
        best, best_m = np.inf, None
        for m in matches:
            pm = p[list(m)]
            d = cdist(pm, pm)
            val = np.triu(np.abs(d_ref - d), k=1).sum() / n / (n - 1) * 2
            if val < best:
                best, best_m = val, m
        out.append(rotate_transform_mirror(ref, p[list(best_m)]))
    return out
