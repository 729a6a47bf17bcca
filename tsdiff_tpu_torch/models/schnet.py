"""SchNet encoder on the dense pair grid.

The continuous-filter convolution is a masked dense contraction over the
(B, N, N, F) pair grid, messages flowing from source i to target j:

    W[b,i,j,f] = filter_mlp(edge_attr)[b,i,j,f] * C(d_ij) * edge_mask
    out[b,j,f] = sum_i W[b,i,j,f] * (h @ lin1)[b,i,f]

The encoder owns the layer-stacked weights (``InteractionStack``), which
drive two paths: ``interaction_stack_xla``, the plain differentiable stack,
and, with ``use_pallas``, the fused CUDA kernels with their own backward
(``ops.schnet_stack.interaction_stack_pallas_trainable``).

With ``embedding`` (the dual encoder's global branch) the encoder embeds atom
types itself: a 100-row table ``node_emb`` whose looked-up rows are scaled to
an L2 norm of at most 10.  That is a clip at lookup; the table itself is
never changed (``nn.Embedding(max_norm=10)`` would renormalise its rows in
place during the forward).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tsdiff_tpu_torch.models.activations import shifted_softplus
from tsdiff_tpu_torch.ops.schnet_stack import interaction_stack_pallas_trainable


class InteractionStack(nn.Module):
    """Layer-stacked SchNet interaction weights, in the checkpoint's flax
    layout: matrices (L, in, out), biases (L, out).  Per block: filter MLP
    f1 (E->F), f2 (F->F); lin1 (H->F, no bias); lin2 (F->H); out (H->H)."""

    def __init__(self, num_blocks: int, hidden: int, filters: int, edge_channels: int):
        super().__init__()
        L, H, F, E = num_blocks, hidden, filters, edge_channels

        def p(*shape):
            return nn.Parameter(torch.zeros(shape))

        self.f1w, self.f1b = p(L, E, F), p(L, F)
        self.f2w, self.f2b = p(L, F, F), p(L, F)
        self.l1w = p(L, H, F)
        self.l2w, self.l2b = p(L, F, H), p(L, H)
        self.ow, self.ob = p(L, H, H), p(L, H)

    def weights(self) -> dict[str, torch.Tensor]:
        return dict(self.named_parameters())


def interaction_stack_xla(
    weights: dict,
    h: torch.Tensor,          # (B, N, H)
    edge_attr: torch.Tensor,  # (B, N, N, E)
    cmask: torch.Tensor,      # (B, N, N) cutoff * edge mask, float
    dtype=torch.float32,
) -> torch.Tensor:
    """The plain residual interaction stack, in ``dtype``."""
    L = weights["f1w"].shape[0]
    c = cmask[..., None].to(dtype)
    w8 = {k: v.to(dtype) for k, v in weights.items()}
    for l in range(L):
        w = shifted_softplus(edge_attr @ w8["f1w"][l] + w8["f1b"][l])
        w = (w @ w8["f2w"][l] + w8["f2b"][l]) * c
        xh = h @ w8["l1w"][l]
        agg = torch.einsum("bijf,bif->bjf", w, xh)
        conv = agg @ w8["l2w"][l] + w8["l2b"][l]
        h = h + (shifted_softplus(conv) @ w8["ow"][l] + w8["ob"][l])
    return h


#: rows of the internal atom embedding are clipped to this L2 norm at lookup
EMBEDDING_MAX_NORM = 10.0


class SchNetEncoder(nn.Module):
    """Residual stack of interaction blocks over node states."""

    def __init__(
        self,
        hidden_channels: int = 128,
        num_filters: int = 128,
        num_interactions: int = 6,
        cutoff: float = 10.0,
        smooth: bool = False,
        use_pallas: bool = False,
        embedding: bool = False,
    ):
        super().__init__()
        self.cutoff = cutoff
        self.smooth = smooth
        self.use_pallas = use_pallas
        self.num_interactions = num_interactions
        if embedding:
            self.node_emb = nn.Embedding(100, hidden_channels)
        # the edge features come in at the node width (edge_cat's output)
        self.stack = InteractionStack(num_interactions, hidden_channels, num_filters,
                                      hidden_channels)

    @classmethod
    def from_config(cls, config, dtype=None, generator=None) -> "SchNetEncoder":
        """An encoder sub-config's SchNet (``load_encoder``), its parameters
        drawn from ``generator``."""
        from tsdiff_tpu_torch.models.init import init_params_

        enc = cls(hidden_channels=config.hidden_dim, num_filters=config.hidden_dim,
                  num_interactions=config.num_convs, cutoff=config.cutoff,
                  smooth=config.smooth_conv)
        init_params_(enc, generator)
        return enc

    def embed(self, z: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Atom types (B, N) -> rows of ``node_emb`` in ``dtype``, each scaled
        to an L2 norm of at most ``EMBEDDING_MAX_NORM`` (the norm taken in
        float32)."""
        emb = F.embedding(z, self.node_emb.weight.to(dtype))
        norm = torch.linalg.vector_norm(emb.float(), dim=-1, keepdim=True)
        scale = torch.clamp(EMBEDDING_MAX_NORM / torch.clamp(norm, min=1e-12), max=1.0)
        return emb * scale.to(dtype)

    def cutoff_mask(self, edge_length: torch.Tensor, emask: torch.Tensor) -> torch.Tensor:
        """C(d) * edge mask, float32."""
        if self.smooth:
            c = 0.5 * (torch.cos(edge_length * math.pi / self.cutoff) + 1.0)
            c = c * (edge_length <= self.cutoff) * (edge_length >= 0.0)
            return c * emask
        return ((edge_length <= self.cutoff) & emask).to(torch.float32)

    def forward(
        self,
        z: torch.Tensor,          # (B, N, H) node states, or (B, N) int atom types
        edge_attr: torch.Tensor,  # (B, N, N, E)
        edge_length: torch.Tensor,
        emask: torch.Tensor,
        dtype: torch.dtype = torch.float32,
        node_mask: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """The node states after the stack; atom types are embedded first
        (``embed``) and masked by ``node_mask``."""
        if hasattr(self, "node_emb") and z.dim() == 2:
            z = self.embed(z, dtype)
            if node_mask is not None:
                z = z * node_mask[..., None].to(dtype)
        weights = self.stack.weights()
        cmask = self.cutoff_mask(edge_length, emask)
        if self.use_pallas:
            return interaction_stack_pallas_trainable(
                weights, z.to(dtype), edge_attr.to(dtype), cmask, dtype
            )
        return interaction_stack_xla(weights, z.to(dtype), edge_attr.to(dtype), cmask, dtype)
