"""The traffic's inputs, made from a seed: one general generator of shards,
whose graphs come from the corpus module that the traffic names
(``corpora/<corpus>.py``, with ``make(rng, n, index, traffic)``).  A later
mix with another kind of graph adds its module; it edits nothing here.

The sizes are not drawn from the seed but are a fixed set, the quantiles of
the traffic's size distribution.  Every seed then asks for the same work
(the same atoms, pairs and buckets) in other graphs, and runs of different
seeds differ no more than runs of one seed.  Graphs come in the on-disk form
(sparse ``edge_index``/``edge_type``), which the program packs with its C++
packer.
"""

from __future__ import annotations

import importlib
import math
import statistics

import numpy as np

#: bond codes: ``reactant type * NUM_BOND_TYPES + product type``
NUM_BOND_TYPES = 22


def size_set(dist: dict, count: int) -> list[int]:
    """``count`` sizes at the quantiles ``(i + 0.5) / count`` of the traffic's
    size distribution, ascending: ``normal`` (``mean``, ``sd``) rounded, or
    ``uniform`` over the integers, both clipped to [``min``, ``max``]."""
    lo, hi = dist["min"], dist["max"]
    qs = [(i + 0.5) / count for i in range(count)]
    if dist["kind"] == "normal":
        nd = statistics.NormalDist(dist["mean"], dist["sd"])
        sizes = [round(nd.inv_cdf(q)) for q in qs]
    elif dist["kind"] == "uniform":
        sizes = [lo + math.floor(q * (hi - lo + 1)) for q in qs]
    else:
        raise ValueError(f"unknown size distribution {dist['kind']!r}")
    return [int(min(max(s, lo), hi)) for s in sizes]


def generator(traffic: dict):
    """The module ``corpora/<corpus>.py`` that makes the traffic's graphs."""
    return importlib.import_module(f"portbench.corpora.{traffic['corpus']}")


def make_shard(traffic: dict, seed: int, shard: int) -> list[dict]:
    """Shard ``shard`` of the traffic: its fixed set of sizes, the graphs
    drawn from ``(seed, shard)``, in the traffic's order (ascending size with
    ``sort_by_size``, else shuffled from the seed)."""
    rng = np.random.default_rng([seed, shard])
    sizes = size_set(traffic["sizes"], traffic["shard"])
    if not traffic.get("sort_by_size", False):
        sizes = [sizes[i] for i in rng.permutation(len(sizes))]
    make = generator(traffic).make
    return [make(rng, n, shard * len(sizes) + i, traffic) for i, n in enumerate(sizes)]


def dense_bonds(g: dict) -> np.ndarray:
    """The graph's (n, n) bond-code matrix from its sparse edges."""
    n = len(g["atom_type"])
    bm = np.zeros((n, n), np.int64)
    ei = np.asarray(g["edge_index"])
    bm[ei[0], ei[1]] = np.asarray(g["edge_type"])
    return bm


def sparse(bm: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """A bond-code matrix's ``(edge_index, edge_type)``."""
    row, col = np.nonzero(bm)
    return np.stack([row, col]).astype(np.int32), bm[row, col].astype(np.int32)
