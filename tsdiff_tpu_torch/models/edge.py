"""Edge encoders on the dense pair grid.

* ``MLPEdgeEncoder``: ``d_emb(edge_length) * bond_emb(edge_type)``, H
  channels;
* ``GaussianSmearingEdgeEncoder``: ``concat[RBF(edge_length),
  bond_emb(edge_type)]``, ``2 * num_gaussians`` channels, the RBF centres
  spread over ``[0, 2 * cutoff]``.

The factors are exposed on their own (``d_embedding``, ``bond_embedding``,
``combine``) so a caller computes the position-independent bond embeddings
once per batch and shares one distance embedding between the encoder and
the output edge orders.
"""

from __future__ import annotations

import numpy as np
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


class GaussianSmearing(nn.Module):
    """RBF expansion ``exp(-0.5 / delta^2 * (d - mu_k)^2)`` of distances over
    ``num_gaussians`` evenly spaced centres ``mu_k`` from ``start`` to
    ``stop``; adds a trailing axis.  The centres are float32, as
    ``jnp.linspace`` makes them, and the coefficient is taken from them."""

    def __init__(self, start: float = 0.0, stop: float = 5.0, num_gaussians: int = 50):
        super().__init__()
        offset = np.linspace(start, stop, num_gaussians, dtype=np.float32)
        self.coeff = -0.5 / float(offset[1] - offset[0]) ** 2
        self.register_buffer("offset", torch.from_numpy(offset), persistent=False)

    def forward(self, dist: torch.Tensor) -> torch.Tensor:
        diff = dist[..., None] - self.offset.to(dist.dtype)
        return torch.exp(self.coeff * diff**2)


class GaussianSmearingEdgeEncoder(nn.Module):
    """edge_length (B, N, N, 1), edge_type (B, N, N) int -> (B, N, N,
    2 * num_gaussians): the RBF of the distance (centres over [0, 2 *
    cutoff]) beside the bond-type embedding, in the type of
    ``edge_length``."""

    def __init__(self, num_gaussians: int = 64, cutoff: float = 10.0):
        super().__init__()
        self.out_channels = 2 * num_gaussians
        self.rbf = GaussianSmearing(0.0, cutoff * 2, num_gaussians)
        self.bond_emb = nn.Embedding(NUM_EDGE_TYPES, num_gaussians)

    def d_embedding(self, edge_length: torch.Tensor) -> torch.Tensor:
        return self.rbf(edge_length[..., 0])

    def bond_embedding(self, edge_type: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return F.embedding(edge_type, self.bond_emb.weight.to(dtype))

    @staticmethod
    def combine(d_emb: torch.Tensor, bond: torch.Tensor) -> torch.Tensor:
        return torch.cat([d_emb, bond], dim=-1)

    def forward(self, edge_length: torch.Tensor, edge_type: torch.Tensor) -> torch.Tensor:
        return self.combine(
            self.d_embedding(edge_length), self.bond_embedding(edge_type, edge_length.dtype)
        )


def make_edge_encoder(kind: str, hidden_dim: int, activation: str, cutoff: float) -> nn.Module:
    """An edge encoder of ``hidden_dim`` channels: ``mlp`` (its MLP's
    activation ``activation``) or ``gaussian`` (``hidden_dim // 2``
    Gaussians up to ``2 * cutoff``)."""
    if kind == "mlp":
        return MLPEdgeEncoder(hidden_dim, activation)
    if kind == "gaussian":
        return GaussianSmearingEdgeEncoder(hidden_dim // 2, cutoff)
    raise NotImplementedError(f"Unknown edge encoder: {kind}")


def get_edge_encoder(config) -> nn.Module:
    """The edge encoder a model config names (``edge_encoder``)."""
    return make_edge_encoder(config.edge_encoder, config.hidden_dim, config.mlp_act,
                             config.cutoff)
