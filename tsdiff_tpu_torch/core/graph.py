"""Padded dense reaction-graph batch.

A batch is a stack of fixed-size padded graphs:

  * ``atom_type``  (B, N)      int64   atomic numbers, 0-padded
  * ``r_feat``     (B, N, F)   uint8   one-hot reactant atom features
  * ``p_feat``     (B, N, F)   uint8   one-hot product atom features
  * ``pos``        (B, N, 3)   float32 coordinates
  * ``bond_mat``   (B, N, N)   int64   condensed bond types
                               ``r_type * NUM_BOND_TYPES + p_type``, 0 = none
  * ``node_mask``  (B, N)      bool    True for real atoms
  * ``is_sidechain`` (B, N)    bool    protein batches only (``data/pdb.py``):
                               True for sidechain atoms, padding False;
                               None for molecules

``N`` is a bucket size.  Packing runs on the host, in the C++ packer
(``data/native.py``) for graphs with sparse edges and in numpy for graphs
with a dense ``bond_mat``; the batch is then moved to its device in one go.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tsdiff_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class ReactionBatch:
    atom_type: torch.Tensor
    r_feat: torch.Tensor
    p_feat: torch.Tensor
    pos: torch.Tensor
    bond_mat: torch.Tensor
    node_mask: torch.Tensor
    #: protein mode: carried inside the batch, so that the loaders, the
    #: prefetcher, the mesh's sharding and the captured steps move it as
    #: they move the rest
    is_sidechain: torch.Tensor | None = None


def from_numpy_graphs(
    graphs: list[dict], max_nodes: int | None = None, device="cpu"
) -> ReactionBatch:
    """Pack host-side graph dicts into a padded ReactionBatch on ``device``.

    Each graph dict has ``atom_type (n,)``, ``r_feat (n,F)``, ``p_feat
    (n,F)``, optional ``pos (n,3)``, and either ``bond_mat (n,n)`` or sparse
    ``edge_index (2,E)`` + ``edge_type (E,)``.  Graphs with sparse edges only
    (the on-disk form) go through the C++ packer, as the JAX package packs
    them (``tsdiff_tpu/core/graph.py:98-110``); a dense ``bond_mat`` takes
    ``pack_numpy``.  Both give the same arrays.  When every graph carries
    ``is_sidechain`` (protein subgraphs, and the empty graphs padding their
    tail), the batch does too, False on padding
    (``tsdiff_tpu/core/graph.py:89-96``).
    """
    with span("pack.host"):
        arrays = _pack_host(graphs, max_nodes)
    with span("pack.copy"):
        return ReactionBatch(**{k: torch.from_numpy(v).to(device) for k, v in arrays.items()})


def _pack_host(graphs: list[dict], max_nodes: int | None) -> dict[str, np.ndarray]:
    """The batch's arrays on the host: the C++ packer for sparse edges,
    ``pack_numpy`` for a dense ``bond_mat``."""
    n_max = max_nodes or max(int(g["atom_type"].shape[0]) for g in graphs)
    for g in graphs:
        n = int(g["atom_type"].shape[0])
        if n > n_max:
            raise ValueError(f"graph with {n} atoms exceeds max_nodes={n_max}")
    if any("bond_mat" in g for g in graphs):
        arrays = pack_numpy(graphs, n_max)
    else:
        from tsdiff_tpu_torch.data.native import pack_batch_native

        atom_type, r_feat, p_feat, pos, bond_mat, node_mask = pack_batch_native(graphs, n_max)
        # the C++ packer writes int32 types and float32 features
        arrays = dict(
            atom_type=atom_type.astype(np.int64), r_feat=r_feat.astype(np.uint8),
            p_feat=p_feat.astype(np.uint8), pos=pos, bond_mat=bond_mat.astype(np.int64),
            node_mask=node_mask,
        )
    if all("is_sidechain" in g for g in graphs):
        sc = np.zeros((len(graphs), n_max), dtype=bool)
        for b, g in enumerate(graphs):
            m = np.asarray(g["is_sidechain"], bool)
            sc[b, : len(m)] = m
        arrays["is_sidechain"] = sc
    return arrays


def pack_numpy(graphs: list[dict], n_max: int) -> dict[str, np.ndarray]:
    """The numpy packer: the batch's arrays as ``from_numpy_graphs`` returns
    them, from graphs with a dense ``bond_mat`` or sparse edges."""
    B = len(graphs)
    feat_dim = int(graphs[0]["r_feat"].shape[-1])

    atom_type = np.zeros((B, n_max), dtype=np.int64)
    r_feat = np.zeros((B, n_max, feat_dim), dtype=np.uint8)
    p_feat = np.zeros((B, n_max, feat_dim), dtype=np.uint8)
    pos = np.zeros((B, n_max, 3), dtype=np.float32)
    bond_mat = np.zeros((B, n_max, n_max), dtype=np.int64)
    node_mask = np.zeros((B, n_max), dtype=bool)

    for b, g in enumerate(graphs):
        n = int(g["atom_type"].shape[0])
        if n > n_max:
            raise ValueError(f"graph with {n} atoms exceeds max_nodes={n_max}")
        atom_type[b, :n] = g["atom_type"]
        r_feat[b, :n] = g["r_feat"]
        p_feat[b, :n] = g["p_feat"]
        if g.get("pos") is not None:
            pos[b, :n] = g["pos"]
        if "bond_mat" in g:
            bond_mat[b, :n, :n] = g["bond_mat"]
        else:
            ei = np.asarray(g["edge_index"])
            bond_mat[b, ei[0], ei[1]] = np.asarray(g["edge_type"])
        node_mask[b, :n] = True

    return dict(
        atom_type=atom_type, r_feat=r_feat, p_feat=p_feat, pos=pos,
        bond_mat=bond_mat, node_mask=node_mask,
    )
