"""Edge encoder on the dense pair grid: ``d_emb(edge_length) *
bond_emb(edge_type)``.

The factors are exposed on their own (``d_embedding``, ``bond_embedding``,
``combine``) so a caller computes the position-independent bond embeddings
once per batch and shares one distance MLP between the encoder and the
output edge orders.  The Gaussian-smearing encoder is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tsdiff_tpu_torch.models.mlp import MLP

#: edge-type embedding table size (covers the condensed high-order codes)
NUM_EDGE_TYPES = 100


class MLPEdgeEncoder(nn.Module):
    """edge_length (B, N, N, 1), edge_type (B, N, N) int -> (B, N, N, H), in
    the type of ``edge_length``."""

    def __init__(self, hidden_dim: int, activation: str):
        super().__init__()
        self.out_channels = hidden_dim
        self.mlp = MLP(1, [hidden_dim, hidden_dim], activation=activation)
        self.bond_emb = nn.Embedding(NUM_EDGE_TYPES, hidden_dim)

    def d_embedding(self, edge_length: torch.Tensor) -> torch.Tensor:
        return self.mlp(edge_length)

    def bond_embedding(self, edge_type: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        # F.embedding's backward reduces the many repeats of a type in
        # parallel; the backward of weight[edge_type] runs each type's
        # repeats in one serial pass
        return F.embedding(edge_type, self.bond_emb.weight.to(dtype))

    @staticmethod
    def combine(d_emb: torch.Tensor, bond: torch.Tensor) -> torch.Tensor:
        return d_emb * bond

    def forward(self, edge_length: torch.Tensor, edge_type: torch.Tensor) -> torch.Tensor:
        return self.combine(
            self.d_embedding(edge_length), self.bond_embedding(edge_type, edge_length.dtype)
        )
