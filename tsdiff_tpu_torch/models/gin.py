"""GIN encoder on the dense pair grid: the local branch of the dual encoder.

``GINEConv`` passes ``act(x_i + edge_attr_ij)`` along each edge i -> j of the
(masked, dense) local edge set, sums at j, adds ``(1 + eps) x_j`` and runs a
two-layer MLP; eps is fixed at 0.  ``GINEncoder`` stacks them with residual
short-cuts, the activation between all but the last, and optionally embeds
atom types first (``node_emb``, a 100-row table).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tsdiff_tpu_torch.models.activations import activation_loader
from tsdiff_tpu_torch.models.mlp import MLP

NUM_ATOM_TYPES = 100


class GINEConv(nn.Module):
    def __init__(self, hidden_dim: int, activation: str = "relu", eps: float = 0.0):
        super().__init__()
        self.eps = eps
        self.act = activation_loader(activation)
        self.nn = MLP(hidden_dim, [hidden_dim, hidden_dim], activation=activation)

    def forward(self, x: torch.Tensor, edge_attr: torch.Tensor,
                emask: torch.Tensor) -> torch.Tensor:
        """x (B, N, H), edge_attr (B, N, N, H), emask (B, N, N) -> (B, N, H)."""
        msg = self.act(x[:, :, None, :] + edge_attr)
        msg = msg * emask[..., None].to(msg.dtype)
        agg = torch.sum(msg, dim=1)
        return self.nn(agg + (1.0 + self.eps) * x)


class GINEncoder(nn.Module):
    def __init__(self, hidden_dim: int, num_convs: int = 3, activation: str = "relu",
                 short_cut: bool = True, concat_hidden: bool = False, embedding: bool = False):
        super().__init__()
        self.short_cut = short_cut
        self.concat_hidden = concat_hidden
        self.act = activation_loader(activation)
        if embedding:
            self.node_emb = nn.Embedding(NUM_ATOM_TYPES, hidden_dim)
        self.convs = nn.ModuleList(GINEConv(hidden_dim, activation) for _ in range(num_convs))

    @classmethod
    def from_config(cls, config, dtype=None, generator=None) -> "GINEncoder":
        """An encoder sub-config's GIN (``load_encoder``): ``hidden_dim``,
        ``num_convs``, ``mlp_act``; its parameters drawn from ``generator``."""
        from tsdiff_tpu_torch.models.init import init_params_

        enc = cls(config.hidden_dim, num_convs=config.num_convs,
                  activation=config.get("mlp_act", "relu"))
        init_params_(enc, generator)
        return enc

    def forward(self, z: torch.Tensor, edge_attr: torch.Tensor, emask: torch.Tensor,
                node_mask: torch.Tensor | None = None) -> torch.Tensor:
        """``z`` (B, N) int atom types with the embedding, else (B, N, H)
        node states; the states in the type of ``edge_attr``."""
        if hasattr(self, "node_emb"):
            h = F.embedding(z, self.node_emb.weight.to(edge_attr.dtype))
        else:
            h = z
        if node_mask is not None:
            h = h * node_mask[..., None].to(h.dtype)
        hiddens = []
        for i, conv in enumerate(self.convs):
            hidden = conv(h, edge_attr, emask)
            if i < len(self.convs) - 1:
                hidden = self.act(hidden)
            if self.short_cut:
                hidden = hidden + h
            hiddens.append(hidden)
            h = hidden
        if self.concat_hidden:
            return torch.cat(hiddens, dim=-1)
        return hiddens[-1]
