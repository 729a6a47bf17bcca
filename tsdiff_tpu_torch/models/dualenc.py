"""DualEncoderEpsNetwork: the GeoDiff-legacy score network, a global and a
local branch over one molecular graph, on the dense pair grid.

* global branch: SchNet with its own atom embedding over the order-extended
  edges united with the radius graph on the current coordinates, its own
  edge encoder, and a distance-score head ``grad_global_dist_mlp``;
* local branch: GIN with its own atom embedding over the typed
  (order-extended) edges only, likewise;
* edge types are the legacy codes of ``extend_graph_order``: bond codes as
  they are, k-hop codes past ``NUM_BOND_TYPES**2``.  Before embedding they
  are decomposed (``decompose_legacy_types``); in TS mode (``TS: true``) a
  bond code is ``r * nb + p`` and each side is embedded and the two fused by
  an ``EdgeCat``;
* ``type: diffusion`` (DDPM, the noise level implicit) or ``type: dsm``
  (annealed score matching: a geometric ladder of ``num_noise_level`` sigmas
  from ``sigma_begin`` to ``sigma_end``, both branches' outputs scaled by
  ``1 / sigma`` of each graph's level).

The SchNet stack runs the plain torch stack (``interaction_stack_xla``), as
the JAX model builds it without ``use_pallas``.  Parameters carry the JAX
model's names (``tsdiff_tpu_torch.convert``) and stay float32; each use casts
them to the working dtype.  The losses and walks are in
``diffusion/dual_objective.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from tsdiff_tpu_torch.chem import NUM_BOND_TYPES
from tsdiff_tpu_torch.core.geometry import pairwise_distance
from tsdiff_tpu_torch.core.graph_ops import extend_graph_order, pair_mask, radius_edge_mask
from tsdiff_tpu_torch.models.condensenc import EdgeCat
from tsdiff_tpu_torch.models.edge import make_edge_encoder
from tsdiff_tpu_torch.models.gin import GINEncoder
from tsdiff_tpu_torch.models.init import init_params_
from tsdiff_tpu_torch.models.mlp import MLP
from tsdiff_tpu_torch.models.schnet import SchNetEncoder


@dataclasses.dataclass(frozen=True)
class DualEdges:
    """Dense legacy edge sets: global = order-extended | radius, local = the
    typed subset (edge_type > 0)."""

    mask_global: torch.Tensor  # (B, N, N) bool
    mask_local: torch.Tensor   # (B, N, N) bool
    edge_type: torch.Tensor    # (B, N, N) int64 legacy codes


def decompose_legacy_types(edge_type: torch.Tensor, ts_mode: bool):
    """Per-side embedding types of legacy codes: ``(t1, t2)`` in TS mode
    (bond code ``r * nb + p`` -> r and p), ``(t1, None)`` otherwise (bond
    code -> ``code % nb``); a k-hop code ``nb**2 + k - 1`` maps to
    ``nb + k - 1`` on every side."""
    nb = NUM_BOND_TYPES
    zero = torch.zeros_like(edge_type)
    is_bondish = edge_type // nb**2 == 0
    high = torch.where(~is_bondish, edge_type % nb**2 + nb, zero)
    if ts_mode:
        t1 = torch.where(is_bondish, edge_type // nb, zero) + high
        t2 = torch.where(is_bondish, edge_type % nb, zero) + high
        return t1, t2
    return torch.where(is_bondish, edge_type % nb, zero) + high, None


class DualEncoderEpsNetwork(nn.Module):
    def __init__(
        self,
        hidden_dim: int = 128,
        num_convs: int = 6,
        num_convs_local: int = 4,
        cutoff: float = 10.0,
        mlp_act: str = "relu",
        edge_order: int = 3,
        edge_encoder: str = "mlp",
        smooth_conv: bool = False,
        model_type: str = "diffusion",
        ts_mode: bool = False,
        edge_cat_act: str = "relu",
        sigma_begin: float = 10.0,
        sigma_end: float = 0.01,
        num_noise_level: int = 50,
        dtype: torch.dtype | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if model_type not in ("diffusion", "dsm"):
            raise NotImplementedError(f"Unknown dual-encoder model type: {model_type}")
        self.hidden_dim = hidden_dim
        self.cutoff = cutoff
        self.edge_order = edge_order
        self.model_type = model_type
        self.ts_mode = ts_mode
        self.sigma_begin, self.sigma_end = sigma_begin, sigma_end
        self.num_noise_level = num_noise_level
        self.dtype = dtype or torch.float32
        self.edge_encoder_global = make_edge_encoder(edge_encoder, hidden_dim, mlp_act, cutoff)
        self.edge_encoder_local = make_edge_encoder(edge_encoder, hidden_dim, mlp_act, cutoff)
        self.encoder_global = SchNetEncoder(
            hidden_channels=hidden_dim, num_filters=hidden_dim, num_interactions=num_convs,
            cutoff=cutoff, smooth=smooth_conv, embedding=True,
        )
        self.encoder_local = GINEncoder(hidden_dim, num_convs=num_convs_local, embedding=True)
        head = [hidden_dim, hidden_dim // 2, 1]
        in_dim = hidden_dim + self.edge_encoder_global.out_channels
        self.grad_global_dist_mlp = MLP(in_dim, head, mlp_act)
        self.grad_local_dist_mlp = MLP(in_dim, head, mlp_act)
        if ts_mode:
            out_ch = self.edge_encoder_global.out_channels
            self.edge_cat_global = EdgeCat(out_ch, edge_cat_act)
            self.edge_cat_local = EdgeCat(out_ch, edge_cat_act)
        self.register_buffer("sigma_table", torch.from_numpy(self.sigmas), persistent=False)
        init_params_(self, generator)

    @classmethod
    def from_config(cls, config, dtype=None, generator=None) -> "DualEncoderEpsNetwork":
        """Build from a model config, as checkpoints embed it."""
        return cls(
            hidden_dim=config.hidden_dim,
            num_convs=config.num_convs,
            num_convs_local=config.num_convs_local,
            cutoff=config.cutoff,
            mlp_act=config.mlp_act,
            edge_order=config.edge_order,
            edge_encoder=config.edge_encoder,
            smooth_conv=config.smooth_conv,
            model_type=config.type,
            ts_mode=bool(config.get("TS", False)),
            edge_cat_act=config.get("edge_cat_act", "relu"),
            sigma_begin=config.get("sigma_begin", 10.0),
            sigma_end=config.get("sigma_end", 0.01),
            num_noise_level=config.get("num_noise_level", 50),
            dtype=dtype,
            generator=generator,
        )

    @property
    def sigmas(self) -> np.ndarray:
        """The DSM ladder, geometric from sigma_begin down to sigma_end
        (float32)."""
        return np.exp(np.linspace(np.log(self.sigma_begin), np.log(self.sigma_end),
                                  self.num_noise_level)).astype(np.float32)

    def typed_edges(self, bond_mat, node_mask, extend_order: bool = True):
        """Position-independent part of ``build_edges``: ``(mask, types)`` of
        the order-extended (or plain) bond graph."""
        if extend_order:
            return extend_graph_order(bond_mat, node_mask, self.edge_order)
        types = torch.where(pair_mask(node_mask), bond_mat, torch.zeros_like(bond_mat))
        return types > 0, types.to(torch.int64)

    def build_edges(self, bond_mat, pos, node_mask, extend_order: bool = True,
                    extend_radius: bool = True, is_sidechain=None, typed=None) -> DualEdges:
        """The legacy edge sets on ``pos``.  With ``is_sidechain`` (B, N)
        bool, radius edges are kept only where an end is a sidechain atom.
        ``typed``: ``typed_edges``'s result, when the caller made it once."""
        mask_typed, types = typed if typed is not None else self.typed_edges(
            bond_mat, node_mask, extend_order)
        if extend_radius:
            rmask = radius_edge_mask(pos, node_mask, self.cutoff)
            if is_sidechain is not None:
                sc = is_sidechain & node_mask
                rmask = rmask & (sc[:, :, None] | sc[:, None, :])
            mask_global = mask_typed | rmask
        else:
            mask_global = mask_typed
        types = torch.where(mask_global, types, torch.zeros_like(types))
        return DualEdges(mask_global=mask_global, mask_local=types > 0, edge_type=types)

    def _edge_attr(self, enc, cat, d, edge_type):
        t1, t2 = decompose_legacy_types(edge_type, self.ts_mode)
        d_in = d.to(self.dtype)[..., None]
        if self.ts_mode:
            return cat(torch.cat([enc(d_in, t1), enc(d_in, t2)], dim=-1))
        return enc(d_in, t1)

    def forward(self, atom_type, pos, bond_mat, node_mask, time_step=None,
                extend_order: bool = True, extend_radius: bool = True, is_sidechain=None,
                typed=None):
        """``(edge_inv_global, edge_inv_local, edges, edge_length)``: the two
        branches' distance scores (B, N, N, 1) float32, meaningful on
        ``edges.mask_global`` and ``edges.mask_local``; ``time_step`` (B,)
        int, the DSM level of each graph (dsm only)."""
        edges = self.build_edges(bond_mat, pos, node_mask, extend_order, extend_radius,
                                 is_sidechain, typed)
        d = pairwise_distance(pos, edges.mask_global)
        if self.model_type == "dsm":
            if time_step is None:
                raise ValueError("a dsm forward needs time_step")
            inv_sigma = 1.0 / self.sigma_table[time_step][:, None, None, None]
        else:
            inv_sigma = 1.0

        def head(mlp, node, attr):
            h_pair = torch.cat([node[:, :, None, :] * node[:, None, :, :], attr], dim=-1)
            return mlp(h_pair).float() * inv_sigma

        attr_g = self._edge_attr(self.edge_encoder_global, getattr(self, "edge_cat_global", None),
                                 d, edges.edge_type)
        node_g = self.encoder_global(atom_type, attr_g, d, edges.mask_global, self.dtype,
                                     node_mask=node_mask)
        edge_inv_global = head(self.grad_global_dist_mlp, node_g, attr_g)

        attr_l = self._edge_attr(self.edge_encoder_local, getattr(self, "edge_cat_local", None),
                                 d, edges.edge_type)
        node_l = self.encoder_local(atom_type, attr_l, edges.mask_local, node_mask)
        edge_inv_local = head(self.grad_local_dist_mlp, node_l, attr_l)
        return edge_inv_global, edge_inv_local, edges, d
