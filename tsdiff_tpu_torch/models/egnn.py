"""EGNN mixed 2D/3D encoder on the dense pair grid (an optional encoder).

Port of ``tsdiff_tpu/models/egnn.py``: per round, an equivariant EGNN layer
over the global (radius) edges updates ``(pos, h)``, mean-aggregated edge
messages plus a coordinate update along pair differences, beside a GINE
conv over the local edges whose messages are gated by the fused R/P edge
attributes; the two node streams are fused by one 2-layer MLP shared by
every round (``lincat``) and added residually (reference egnn.py:95-110).

Modules carry the JAX model's parameter names (``egnn_<i>``, ``gin_<i>``,
``lincat``), so ``tsdiff_tpu_torch.convert`` moves weights between the two.
Dropout follows the module's ``train()``/``eval()`` mode, where the JAX
module takes ``deterministic``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tsdiff_tpu_torch.models.activations import activation_loader
from tsdiff_tpu_torch.models.mlp import linear


def masked_mean(msgs: torch.Tensor, emask: torch.Tensor, dim: int) -> torch.Tensor:
    """Mean over the real edges along ``dim`` (a dense scatter-mean)."""
    m = emask[..., None].to(msgs.dtype)
    s = torch.sum(msgs * m, dim=dim)
    cnt = torch.clamp(torch.sum(m, dim=dim), min=1.0)
    return s / cnt


def init_torch_linear_(module: nn.Module, gen: torch.Generator | None) -> None:
    """Every ``nn.Linear`` of ``module``: weight and bias U(-1/sqrt(fan_in),
    +1/sqrt(fan_in)), the JAX package's ``TorchLinear`` init; LayerNorms
    ones and zeros."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                m.weight.uniform_(-bound, bound, generator=gen)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=gen)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``norm(x)`` in x's type from the float32 parameters."""
    return F.layer_norm(x, norm.normalized_shape, norm.weight.to(x.dtype),
                        norm.bias.to(x.dtype), norm.eps)


def _norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6)  # flax's default epsilon


class MLP2(nn.Module):
    """Linear -> activation -> Linear (``lin0``, ``lin1``): the shape of
    ``edge_cat``, ``fin_layer`` and ``lincat``."""

    def __init__(self, in_dim: int, mid: int, out: int, act: str = "swish"):
        super().__init__()
        self.lin0 = nn.Linear(in_dim, mid)
        self.lin1 = nn.Linear(mid, out)
        self.act = activation_loader(act)

    def forward(self, x):
        return linear(self.lin1, self.act(linear(self.lin0, x)))


class EGNNSparseLayer(nn.Module):
    """Equivariant layer (reference egnn.py:178-296), dense: for each
    directed pair (s -> t) of the global edges, with ``dist = |pos_t -
    pos_s|^2``, ``m1 = LN(mlp1([x_t, x_s, dist]))`` and ``m2 = (pos_t -
    pos_s) * LN(mlp2(...))`` are mean-aggregated at t; then ``x += LN(
    node_mlp([LN(x), m1_t]))`` and ``pos += m2_t``."""

    def __init__(self, hidden_dim: int, dropout: float = 0.1):
        super().__init__()
        H = hidden_dim
        self.drop = nn.Dropout(dropout)
        for name, out in (("edge_mlp1", H // 2), ("edge_mlp2", 1)):
            self.add_module(f"{name}_lin0", nn.Linear(2 * H + 1, 2 * H))
            self.add_module(f"{name}_lin1", nn.Linear(2 * H, out))
        self.edge_norm1 = _norm(H // 2)
        self.edge_norm2 = _norm(1)
        self.node_norm1 = _norm(H)
        self.node_mlp_lin0 = nn.Linear(H + H // 2, 2 * H)
        self.node_mlp_lin1 = nn.Linear(2 * H, H)
        self.node_norm2 = _norm(H)

    def _mlp(self, name: str, v):
        v = F.silu(self.drop(linear(getattr(self, f"{name}_lin0"), v)))
        return F.silu(linear(getattr(self, f"{name}_lin1"), v))

    def forward(self, pos, x, emask):
        n = x.shape[1]
        diff = pos[:, :, None, :] - pos[:, None, :, :]          # [t, s] = pos_t - pos_s
        dist = torch.sum(diff * diff, dim=-1, keepdim=True)
        feat = torch.cat([x[:, :, None, :].expand(-1, -1, n, -1),
                          x[:, None, :, :].expand(-1, n, -1, -1), dist.to(x.dtype)], dim=-1)
        m1 = layer_norm(self.edge_norm1, self._mlp("edge_mlp1", feat))
        m2 = layer_norm(self.edge_norm2, self._mlp("edge_mlp2", feat))
        m2 = diff * m2.to(diff.dtype)
        m1_t = masked_mean(m1, emask, dim=2)                    # mean over sources
        m2_t = masked_mean(m2, emask, dim=2)
        upd = torch.cat([layer_norm(self.node_norm1, x), m1_t], dim=-1)
        upd = F.silu(self.drop(linear(self.node_mlp_lin0, upd)))
        upd = layer_norm(self.node_norm2, linear(self.node_mlp_lin1, upd))
        return pos + m2_t, x + upd


class GINEConvGated(nn.Module):
    """GINE variant whose message along (s -> t) is ``silu(x_s * edge_cat(
    [attr_r, attr_p])[s, t])``, summed at t, then ``fin_layer(agg + x)``
    (reference egnn.py:113-159)."""

    def __init__(self, hidden_dim: int):
        super().__init__()
        H = hidden_dim
        self.edge_cat = MLP2(2 * H, 2 * H, H)
        self.fin_layer = MLP2(H, 2 * H, H)

    def forward(self, x, attr_r, attr_p, emask):
        gate = self.edge_cat(torch.cat([attr_r, attr_p], dim=-1))
        msg = F.silu(x[:, :, None, :] * gate)                  # index (s, t)
        msg = msg * emask[..., None].to(msg.dtype)
        return self.fin_layer(torch.sum(msg, dim=1) + x)


class EGNNMixed2DEncoder(nn.Module):
    """Interleaved EGNN (3D, global edges) and gated GINE (2D, local R/P
    edges) rounds (reference egnn.py:10-110)."""

    def __init__(self, hidden_dim: int = 128, num_convs: int = 5, dropout: float = 0.1,
                 dtype: torch.dtype | None = None, generator: torch.Generator | None = None):
        super().__init__()
        self.hidden_dim, self.num_convs = hidden_dim, num_convs
        self.dtype = dtype or torch.float32
        self.lincat = MLP2(2 * hidden_dim, 2 * hidden_dim, hidden_dim)
        for i in range(num_convs):
            self.add_module(f"egnn_{i}", EGNNSparseLayer(hidden_dim, dropout))
            self.add_module(f"gin_{i}", GINEConvGated(hidden_dim))
        init_torch_linear_(self, generator)

    @classmethod
    def from_config(cls, config, dtype=None, generator=None) -> "EGNNMixed2DEncoder":
        return cls(hidden_dim=config.hidden_dim, num_convs=config.num_convs,
                   dropout=config.get("dropout", 0.1), dtype=dtype, generator=generator)

    def forward(self, node, mask_local, attr_r, attr_p, mask_global, pos):
        """node (B, N, H), the local mask and R/P attributes (B, N, N[, H]),
        the global mask (B, N, N), pos (B, N, 3) -> (B, N, H)."""
        h = node.to(self.dtype)
        attr_r, attr_p = attr_r.to(self.dtype), attr_p.to(self.dtype)
        for i in range(self.num_convs):
            pos, h1 = getattr(self, f"egnn_{i}")(pos, h, mask_global)
            h2 = getattr(self, f"gin_{i}")(h, attr_r, attr_p, mask_local)
            h = h + self.lincat(torch.cat([h1, h2], dim=-1))
        return h
