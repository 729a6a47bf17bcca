"""Batched dense graph construction for the condensed reaction graph.

Given condensed bond types T = r*22 + p on the 2D reaction graph:

  - split into per-R and per-P bond-type matrices (r = T // 22, p = T % 22);
  - build each side's higher-order adjacency: hop count 1..order via boolean
    adjacency powers; k-hop (k >= 2) edges get type 22 + k - 1;
  - the local edge set is the union of R-side and P-side edges, carrying
    separate ``type_r``/``type_p`` (0 where that side has no edge).

The message-passing edge set is the local set united with a radius graph on
the current coordinates (``radius_edge_mask``; ``extend_condensed_graph_edge``
builds both).  The GeoDiff-legacy single graph has its own extension
(``extend_graph_order``, ``extend_graph_order_radius``): the bond codes kept
as they are, k-hop codes offset past the whole condensed vocabulary.
Everything is (B, N, N) dense.  The adjacency powers run as float matmuls on
0/1 matrices (exact: every entry is an integer <= N), since CUDA has no
integer matmul.
"""

from __future__ import annotations

import dataclasses

import torch

from tsdiff_tpu_torch.chem import NUM_BOND_TYPES


@dataclasses.dataclass(frozen=True)
class GraphEdges:
    """Dense edge sets of one padded batch: ``mask_global`` (local | radius)
    is what the score network passes messages over, ``mask_local`` the
    order-extended 2D set; ``type_r``/``type_p`` are 0 off the local set."""

    mask_global: torch.Tensor  # (B, N, N) bool
    mask_local: torch.Tensor   # (B, N, N) bool
    type_r: torch.Tensor       # (B, N, N) int64
    type_p: torch.Tensor       # (B, N, N) int64


def pair_mask(node_mask: torch.Tensor) -> torch.Tensor:
    """(B,N) node mask -> (B,N,N) off-diagonal real-pair mask."""
    m = node_mask[:, :, None] & node_mask[:, None, :]
    eye = torch.eye(node_mask.shape[-1], dtype=torch.bool, device=node_mask.device)
    return m & ~eye


def higher_order_adj(adj: torch.Tensor, order: int) -> torch.Tensor:
    """Hop-count matrix: entry = k if the shortest path is k hops
    (1 <= k <= order), else 0; 0 on the diagonal."""
    n = adj.shape[-1]
    eye = torch.eye(n, dtype=torch.float32, device=adj.device)
    a0 = eye.expand(adj.shape)
    a1 = ((adj.to(torch.float32) + eye) > 0).to(torch.float32)
    mats = [a0, a1]
    for _ in range(2, order + 1):
        mats.append((torch.matmul(mats[-1], a1) > 0).to(torch.float32))
    order_mat = torch.zeros(adj.shape, dtype=torch.int64, device=adj.device)
    for k in range(1, order + 1):
        order_mat = order_mat + (mats[k] - mats[k - 1]).to(torch.int64) * k
    return order_mat


def _typed_higher_order(type_mat: torch.Tensor, order: int) -> torch.Tensor:
    """One side (R or P): direct bond types plus hop types
    ``NUM_BOND_TYPES + k - 1`` for k-hop (k >= 2) pairs."""
    hop = higher_order_adj(type_mat > 0, order)
    type_high = torch.where(hop > 1, NUM_BOND_TYPES + hop - 1, torch.zeros_like(hop))
    return type_mat.to(torch.int64) + type_high


def extend_ts_graph(
    bond_mat: torch.Tensor, node_mask: torch.Tensor, order: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Order-extended condensed R/P local graph: ``(mask_local, type_r,
    type_p)``, (B,N,N) bool / int64 / int64."""
    pm = pair_mask(node_mask)
    zero = torch.zeros_like(bond_mat)
    type_mat_r = torch.where(pm, bond_mat // NUM_BOND_TYPES, zero)
    type_mat_p = torch.where(pm, bond_mat % NUM_BOND_TYPES, zero)
    type_r = _typed_higher_order(type_mat_r, order)
    type_p = _typed_higher_order(type_mat_p, order)
    mask_local = ((type_r > 0) | (type_p > 0)) & pm
    type_r = torch.where(mask_local, type_r, torch.zeros_like(type_r))
    type_p = torch.where(mask_local, type_p, torch.zeros_like(type_p))
    return mask_local, type_r, type_p


@dataclasses.dataclass(frozen=True)
class StaticPairs:
    """Position-independent pair structures, computed once per batch.
    ``*_in`` is the encoder edge set (``edge_order``), ``*_out`` the output
    head's (``pred_edge_order``); with equal orders they alias."""

    mask_local_in: torch.Tensor
    type_r_in: torch.Tensor
    type_p_in: torch.Tensor
    mask_local_out: torch.Tensor
    type_r_out: torch.Tensor
    type_p_out: torch.Tensor


def precompute_static_pairs(
    bond_mat: torch.Tensor, node_mask: torch.Tensor, edge_order: int, pred_edge_order: int
) -> StaticPairs:
    m_in, tr_in, tp_in = extend_ts_graph(bond_mat, node_mask, edge_order)
    if pred_edge_order == edge_order:
        m_out, tr_out, tp_out = m_in, tr_in, tp_in
    else:
        m_out, tr_out, tp_out = extend_ts_graph(bond_mat, node_mask, pred_edge_order)
    return StaticPairs(m_in, tr_in, tp_in, m_out, tr_out, tp_out)


def radius_edge_mask(pos: torch.Tensor, node_mask: torch.Tensor, cutoff: float) -> torch.Tensor:
    """All intra-graph pairs with distance <= cutoff, no self loops (B, N, N)."""
    diff = pos[:, :, None, :] - pos[:, None, :, :]
    sq = torch.sum(diff * diff, dim=-1)
    return (sq <= cutoff * cutoff) & pair_mask(node_mask)


def extend_condensed_graph_edge(
    bond_mat: torch.Tensor, pos: torch.Tensor, node_mask: torch.Tensor, order: int,
    cutoff: float,
) -> GraphEdges:
    """The condensed model's edge sets on ``pos``: the order-extended local
    set, and the global set, local united with the radius graph, each global
    edge carrying its local ``type_r``/``type_p`` (0 if none)."""
    mask_local, type_r, type_p = extend_ts_graph(bond_mat, node_mask, order)
    mask_global = mask_local | radius_edge_mask(pos, node_mask, cutoff)
    return GraphEdges(mask_global=mask_global, mask_local=mask_local, type_r=type_r,
                      type_p=type_p)


def extend_graph_order(
    type_mat: torch.Tensor, node_mask: torch.Tensor, order: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """GeoDiff-legacy single-graph order extension: ``(mask, types)``, bond
    codes kept, k-hop (k >= 2) pairs typed ``NUM_BOND_TYPES**2 + k - 1``
    (past the whole condensed vocabulary)."""
    pm = pair_mask(node_mask)
    type_mat = torch.where(pm, type_mat, torch.zeros_like(type_mat)).to(torch.int64)
    hop = higher_order_adj(type_mat > 0, order)
    type_high = torch.where(hop > 1, NUM_BOND_TYPES**2 + hop - 1, torch.zeros_like(hop))
    type_new = type_mat + type_high
    return (type_new > 0) & pm, type_new


def extend_graph_order_radius(
    type_mat: torch.Tensor,
    pos: torch.Tensor,
    node_mask: torch.Tensor,
    order: int,
    cutoff: float,
    extend_order: bool = True,
    extend_radius: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The legacy edge set: the order-extended edges united with the radius
    graph on ``pos``; radius-only edges have type 0."""
    pm = pair_mask(node_mask)
    if extend_order:
        mask, types = extend_graph_order(type_mat, node_mask, order)
    else:
        types = torch.where(pm, type_mat, torch.zeros_like(type_mat)).to(torch.int64)
        mask = types > 0
    if extend_radius:
        mask = mask | radius_edge_mask(pos, node_mask, cutoff)
        types = torch.where(mask, types, torch.zeros_like(types))
    return mask, types
