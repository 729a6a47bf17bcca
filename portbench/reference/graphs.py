"""Plain graph arithmetic of the reference: padded dense batches from the
traffic's graphs, hop counts, typed edge sets of a given order, radius
graphs and masked distances.  Plain torch and numpy; nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.corpus import NUM_BOND_TYPES, dense_bonds


def dense_batch(graphs: list[dict], n_pad: int, device) -> dict:
    """The graphs padded to ``n_pad`` atoms: ``atom_type`` (B, N) int64,
    ``r_feat``/``p_feat`` (B, N, F) float32, ``bond_mat`` (B, N, N) int64,
    ``node_mask`` (B, N) bool, ``pos`` (B, N, 3) float32."""
    B, F = len(graphs), int(np.asarray(graphs[0]["r_feat"]).shape[-1])
    out = dict(atom_type=np.zeros((B, n_pad), np.int64), r_feat=np.zeros((B, n_pad, F), np.float32),
               p_feat=np.zeros((B, n_pad, F), np.float32), bond_mat=np.zeros((B, n_pad, n_pad), np.int64),
               node_mask=np.zeros((B, n_pad), bool), pos=np.zeros((B, n_pad, 3), np.float32))
    for b, g in enumerate(graphs):
        n = len(g["atom_type"])
        out["atom_type"][b, :n] = g["atom_type"]
        out["r_feat"][b, :n] = g["r_feat"]
        out["p_feat"][b, :n] = g["p_feat"]
        out["bond_mat"][b, :n, :n] = dense_bonds(g)
        out["node_mask"][b, :n] = True
        out["pos"][b, :n] = g["pos"]
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def pair_mask(node_mask: torch.Tensor) -> torch.Tensor:
    """Pairs of two different real atoms (B, N, N)."""
    n = node_mask.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=node_mask.device)
    return node_mask[:, :, None] & node_mask[:, None, :] & ~eye


def hop_counts(adj: torch.Tensor, order: int) -> torch.Tensor:
    """Shortest-path hop count (1..order) between atoms, 0 beyond ``order``
    and on the diagonal, from a (B, N, N) bool adjacency."""
    n = adj.shape[-1]
    eye = torch.eye(n, dtype=torch.float64, device=adj.device).expand(adj.shape)
    step = ((adj.double() + eye) > 0).double()
    reach = eye
    hops = torch.zeros(adj.shape, dtype=torch.int64, device=adj.device)
    for k in range(1, order + 1):
        nxt = ((reach @ step) > 0).double()
        hops = hops + ((nxt - reach) > 0).long() * k
        reach = nxt
    return hops


def typed_edges(bond_mat: torch.Tensor, node_mask: torch.Tensor, order: int):
    """The condensed graph's local edges at ``order``: ``(mask, type_r,
    type_p)``.  Each side's bond type is ``code // 22`` (reactant) or
    ``code % 22`` (product); a pair k >= 2 hops apart on a side is typed
    ``22 + k - 1`` there; a pair is local where either side types it."""
    pm = pair_mask(node_mask)
    out = []
    for side in (bond_mat // NUM_BOND_TYPES, bond_mat % NUM_BOND_TYPES):
        side = torch.where(pm, side, torch.zeros_like(side))
        hop = hop_counts(side > 0, order)
        out.append(side + torch.where(hop > 1, NUM_BOND_TYPES + hop - 1, torch.zeros_like(hop)))
    type_r, type_p = out
    mask = ((type_r > 0) | (type_p > 0)) & pm
    zero = torch.zeros_like(type_r)
    return mask, torch.where(mask, type_r, zero), torch.where(mask, type_p, zero)


def legacy_edges(bond_mat: torch.Tensor, node_mask: torch.Tensor, order: int):
    """The one-graph edges of GeoDiff at ``order``: ``(mask, types)``, bond
    codes as they are, k >= 2 hops typed ``22 ** 2 + k - 1``."""
    pm = pair_mask(node_mask)
    types = torch.where(pm, bond_mat, torch.zeros_like(bond_mat))
    hop = hop_counts(types > 0, order)
    types = types + torch.where(hop > 1, NUM_BOND_TYPES ** 2 + hop - 1, torch.zeros_like(hop))
    return (types > 0) & pm, types


def distances(pos: torch.Tensor) -> torch.Tensor:
    """All pairwise distances (B, N, N); the diagonal 0."""
    diff = pos[:, :, None, :] - pos[:, None, :, :]
    return torch.sqrt((diff * diff).sum(-1))


def center(pos: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """Each graph's real atoms moved so that their mean is 0; padding 0."""
    m = node_mask[..., None].to(pos.dtype)
    mean = (pos * m).sum(1, keepdim=True) / m.sum(1, keepdim=True).clamp(min=1)
    return (pos - mean) * m


def scores_to_atoms(score: torch.Tensor, pos: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-atom vectors of pair distance scores: atom i gets
    ``sum_j m_ij (s_ij + s_ji) (r_i - r_j) / d_ij`` (B, N, 3)."""
    diff = pos[:, :, None, :] - pos[:, None, :, :]
    d = torch.sqrt((diff * diff).sum(-1))
    w = torch.where(mask, score, torch.zeros_like(score))
    w = (w + w.transpose(1, 2)) / torch.where(mask, d, torch.ones_like(d))
    return (w[..., None] * diff).sum(2)


def clip_norm(vec: torch.Tensor, limit: float) -> torch.Tensor:
    """Each atom's vector scaled down to norm ``limit`` where it is longer."""
    norm = vec.norm(dim=-1, keepdim=True)
    return torch.where(norm > limit, vec * (limit / norm.clamp(min=1e-30)), vec)
