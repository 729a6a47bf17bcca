"""CondenseEncoderEpsNetwork — the transition-state score network.

Structure (hidden H = 256 in the trained checkpoints):

  node state   z = concat[atom_emb(Z) + feat_emb(r_feat),
                          feat_emb(p_feat) - feat_emb(r_feat)]   (B,N,H)
  edges        condensed R/P extension at ``edge_order`` + radius graph
  edge attr    edge_cat(concat[d_emb(d) * bond_emb(type_r),
                               d_emb(d) * bond_emb(type_p)])
  encoder      L SchNet interaction blocks over the global edge set
  head         re-extended at ``pred_edge_order``, then
               edge_inv = grad_dist_mlp(concat[h_i * h_j, edge_attr])

Parameters carry the checkpoint's names (``tsdiff_tpu_torch.convert``).
The sampling path runs the offset-packed score step
(``score_step_packed``), whose pair work is the fused op
``tsdiff_tpu_torch.ops.packed_score``.  The dense ``score_step`` and the
training forward are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from tsdiff_tpu_torch.core.graph_ops import precompute_static_pairs
from tsdiff_tpu_torch.core.packed import (
    PackedPairs,
    half_last_slab_mask,
    pack_static_pairs,
    packed_distance,
    packed_valid_mask,
)
from tsdiff_tpu_torch.models.mlp import MLP
from tsdiff_tpu_torch.ops.packed_score import extract_weights_packed, packed_score

NUM_ATOM_TYPES = 100  # atomic-number embedding table size
NUM_EDGE_TYPES = 100  # bond-type embedding table size


class PackedPairInfo(NamedTuple):
    """Member-invariant per-step quantities in offset-packed layout."""

    d_in: torch.Tensor    # (B, K, N) masked distances, encoder edge set
    cmask: torch.Tensor   # (B, K, N) float cutoff & encoder mask & 0.5-last-slab
    d_out: torch.Tensor   # (B, K, N) masked distances, output-head edge set
    m_eq: torch.Tensor    # (B, K, N) float output mask & 0.5-last-slab


class MLPEdgeEncoder(nn.Module):
    """d_emb(edge_length) * bond_emb(edge_type)."""

    def __init__(self, hidden_dim: int, activation: str):
        super().__init__()
        self.mlp = MLP(1, [hidden_dim, hidden_dim], activation=activation)
        self.bond_emb = nn.Embedding(NUM_EDGE_TYPES, hidden_dim)


class EdgeCat(nn.Module):
    """2-layer fusion MLP of the concatenated R/P edge embeddings."""

    def __init__(self, channels: int):
        super().__init__()
        self.lin0 = nn.Linear(2 * channels, channels)
        self.lin1 = nn.Linear(channels, channels)


class InteractionStack(nn.Module):
    """Layer-stacked SchNet interaction weights, in the checkpoint's flax
    layout: matrices (L, in, out), biases (L, out)."""

    def __init__(self, num_blocks: int, hidden: int, filters: int):
        super().__init__()
        L, H, F_ = num_blocks, hidden, filters

        def p(*shape):
            return nn.Parameter(torch.zeros(shape))

        self.f1w, self.f1b = p(L, H, F_), p(L, F_)
        self.f2w, self.f2b = p(L, F_, F_), p(L, F_)
        self.l1w = p(L, H, F_)
        self.l2w, self.l2b = p(L, F_, H), p(L, H)
        self.ow, self.ob = p(L, H, H), p(L, H)


class SchNetEncoder(nn.Module):
    def __init__(self, num_blocks: int, hidden: int, filters: int):
        super().__init__()
        self.stack = InteractionStack(num_blocks, hidden, filters)


class CondenseEncoderEpsNetwork(nn.Module):
    def __init__(
        self,
        hidden_dim: int = 256,
        feat_dim: int = 25,
        edge_encoder: str = "mlp",
        mlp_act: str = "swish",
        edge_cat_act: str = "swish",
        edge_order: int = 4,
        pred_edge_order: int = 3,
        edge_cutoff: float = 10.0,
        num_convs: int = 7,
        cutoff: float = 10.0,
        smooth_conv: bool = False,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        if edge_encoder != "mlp" or smooth_conv or mlp_act != "swish" or edge_cat_act != "swish":
            raise NotImplementedError(
                "the port supports the mlp edge encoder with swish activations and a "
                "hard cutoff (the trained configuration) only"
            )
        if hidden_dim % 2:
            raise ValueError("hidden_dim must be even")
        self.hidden_dim = hidden_dim
        self.edge_order = edge_order
        self.pred_edge_order = pred_edge_order
        self.edge_cutoff = edge_cutoff
        self.num_convs = num_convs
        self.cutoff = cutoff
        self.dtype = dtype or torch.float32
        half = hidden_dim // 2
        self.atom_embedding = nn.Embedding(NUM_ATOM_TYPES, half)
        self.atom_feat_embedding = nn.Linear(feat_dim, half, bias=False)
        self.edge_enc = MLPEdgeEncoder(hidden_dim, mlp_act)
        self.edge_cat = EdgeCat(hidden_dim)
        self.encoder = SchNetEncoder(num_convs, hidden_dim, hidden_dim)
        self.grad_dist_mlp = MLP(2 * hidden_dim, [hidden_dim, hidden_dim // 2, 1], mlp_act)

    @classmethod
    def from_config(cls, config, dtype=None) -> "CondenseEncoderEpsNetwork":
        """Build from a model config, as checkpoints embed it."""
        enc = config.encoder
        if enc.name != "schnet":
            raise NotImplementedError(f"unsupported encoder {enc.name} for condensenc")
        return cls(
            hidden_dim=config.hidden_dim,
            feat_dim=config.feat_dim,
            edge_encoder=config.edge_encoder,
            mlp_act=config.mlp_act,
            edge_cat_act=config.edge_cat_act,
            edge_order=config.edge_order,
            pred_edge_order=config.get("pred_edge_order", config.edge_order),
            edge_cutoff=config.edge_cutoff,
            num_convs=enc.num_convs,
            cutoff=enc.cutoff,
            smooth_conv=enc.smooth_conv,
            dtype=dtype,
        )

    @torch.no_grad()
    def node_states(self, atom_type, r_feat, p_feat, node_mask) -> torch.Tensor:
        """Condensed node states z = [a + af_r, af_p - af_r] (B, N, H) in the
        working dtype; position-independent.  Products accumulate in float32
        from working-dtype operands and round once."""
        dt = self.dtype
        a_emb = self.atom_embedding.weight.to(dt)[atom_type]
        w = self.atom_feat_embedding.weight.to(dt).float()
        af_r = F.linear(r_feat.to(dt).float(), w).to(dt)
        af_p = F.linear(p_feat.to(dt).float(), w).to(dt)
        z = torch.cat([a_emb + af_r, af_p - af_r], dim=-1)
        return z * node_mask[..., None].to(dt)

    def precompute_packed_pairs(self, bond_mat, node_mask) -> PackedPairs:
        """Offset-packed typed pair structures; member-invariant, once per batch."""
        return pack_static_pairs(
            precompute_static_pairs(bond_mat, node_mask, self.edge_order, self.pred_edge_order)
        )

    def build_packed_pair_info(self, pos, node_mask, pp: PackedPairs) -> PackedPairInfo:
        """Per-step member-invariant packed masks and distances.  The 0.5
        factor on the k = N/2 slab rides inside the float masks."""
        n = pos.shape[1]
        valid = packed_valid_mask(node_mask)
        d_raw = packed_distance(pos, valid)
        mask_radius = valid & (d_raw <= self.edge_cutoff)
        half = half_last_slab_mask(n, device=pos.device)[None]  # (1, K, 1)
        one = torch.ones_like(d_raw)

        mask_in = pp.mask_local_in | mask_radius
        d_in = torch.where(mask_in, d_raw, one)
        cmask = ((d_in <= self.cutoff) & mask_in).to(torch.float32) * half
        if self.pred_edge_order == self.edge_order:
            mask_out, d_out = mask_in, d_in
        else:
            mask_out = pp.mask_local_out | mask_radius
            d_out = torch.where(mask_out, d_raw, one)
        m_eq = mask_out.to(torch.float32) * half
        return PackedPairInfo(d_in=d_in, cmask=cmask, d_out=d_out, m_eq=m_eq)

    def kernel_weights(self) -> dict[str, torch.Tensor]:
        """This member's score-kernel weights in the working dtype."""
        w = extract_weights_packed(self.state_dict())
        return {k: v.to(self.dtype).contiguous() for k, v in w.items()}

    @torch.no_grad()
    def score_step_packed(self, pos, node_mask, z, pp: PackedPairs, pair_info=None):
        """Packed ``edge_inv`` (B, K, N) float32 of this one model.  Chain-rule
        with ``core.packed.eq_transform_packed(out, pos, info.m_eq, info.d_out)``."""
        if pair_info is None:
            pair_info = self.build_packed_pair_info(pos, node_mask, pp)
        w = {k: v[None] for k, v in self.kernel_weights().items()}
        out = packed_score(
            w, z[None].contiguous(), pair_info.d_in.contiguous(), pair_info.cmask.contiguous(),
            pp.type_r_in, pp.type_p_in, pp.type_r_out, pp.type_p_out,
            num_blocks=self.num_convs,
        )
        return out[0]
