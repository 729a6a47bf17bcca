"""ComENet encoder on the dense pair grid (an optional encoder).

Port of ``tsdiff_tpu/models/comenet.py``: complete and efficient message
passing with per-node nearest and second-nearest reference partners and
rotation-invariant ``(d, theta, phi, tau)`` edge coordinates, fed through
the joint Bessel x spherical-harmonic bases (``TorsionEmb``/``AngleEmb``,
``ops/basis.py``) and fused with R/P bond-type embeddings through one shared
``edge_cat`` (reference comenet.py:599-614).  The reference's scatter-min
frame selection is a masked dense argmin over each node's incident edges;
the edge (j -> i) is the dense entry [i, j] ([target, source]).  As in the
JAX module, each interaction's conv consumes its fused (geometry x bond)
edge attribute, with the attention gate intact.  One difference: two
angles are ill-conditioned on edges where the exact computation meets
atan2 of a zero and the rounding's sign folds them to 0 or pi at random
(``comenet_features`` gives them their exact values): phi on an edge that
is one of the target's two reference vectors (0), and tau on an edge whose
two ends take the same reference atom (pi).

Linear layers are ``Dense`` (glorot-uniform kernels, zero biases; the
output layer zero), named as the JAX parameters, so
``tsdiff_tpu_torch.convert`` moves weights both ways.  Dropout follows the
module's ``train()``/``eval()`` mode, where the JAX module takes
``deterministic``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tsdiff_tpu_torch.models.mlp import Dense, linear
from tsdiff_tpu_torch.ops.basis import AngleEmb, TorsionEmb


class TwoLayerLinear(nn.Module):
    """(reference comenet.py:96-129): ``lin1``, ``lin2``, each followed by
    dropout and, with ``act``, silu."""

    def __init__(self, in_dim: int, middle: int, out: int, dropout: float = 0.1,
                 act: bool = True):
        super().__init__()
        self.lin1 = Dense(in_dim, middle)
        self.lin2 = Dense(middle, out)
        self.drop = nn.Dropout(dropout)
        self.act = act

    def forward(self, x):
        x = self.drop(linear(self.lin1, x))
        if self.act:
            x = F.silu(x)
        x = self.drop(linear(self.lin2, x))
        return F.silu(x) if self.act else x


def dense_frames(dist: torch.Tensor, emask: torch.Tensor, cutoff: float):
    """Each node's nearest (``n0``) and second-nearest (``n1``) partner over
    its incident edges, (B, N) each; a node with no edge gets index 0 (its
    features are masked downstream, as the reference clamps its argmin)."""
    big = torch.tensor(1e30, dtype=dist.dtype, device=dist.device)
    d0 = torch.where(emask, dist, big)
    n0 = torch.argmin(d0, dim=-1)
    d1 = d0 + F.one_hot(n0, dist.shape[-1]).to(dist.dtype) * big
    return n0, torch.argmin(d1, dim=-1)


def comenet_features(pos: torch.Tensor, emask: torch.Tensor, cutoff: float):
    """``(dist, theta, phi, tau)`` per dense edge [i, j] = (j -> i), each
    angle folded into [0, pi) (reference comenet.py:370-454)."""
    V = pos[:, None, :, :] - pos[:, :, None, :]             # V[t, s] = pos_s - pos_t
    dist = torch.sqrt(torch.clamp(torch.sum(V * V, dim=-1), min=1e-18))
    n0, n1 = dense_frames(dist, emask, cutoff)
    N = dist.shape[1]

    def gather_vec(idx):  # v[t] = V[t, idx[t]]
        return torch.gather(V, 2, idx[:, :, None, None].expand(-1, -1, 1, 3))[:, :, 0]

    v0, v1 = gather_vec(n0), gather_vec(n1)
    pos_ji = V
    pos_in0 = v0[:, :, None, :].expand_as(V)
    pos_in1 = v1[:, :, None, :].expand_as(V)

    def fold(x):
        return torch.where(x < 0, x + math.pi, x)

    cross = lambda a, b: torch.linalg.cross(a, b, dim=-1)  # noqa: E731
    a = torch.sum(-pos_ji * pos_in0, dim=-1)
    b = torch.linalg.norm(cross(-pos_ji, pos_in0), dim=-1)
    theta = fold(torch.atan2(b, a))

    dist_safe = torch.clamp(dist, min=1e-9)
    plane1 = cross(-pos_ji, pos_in0)
    plane2 = cross(-pos_ji, pos_in1)
    a = torch.sum(plane1 * plane2, dim=-1)
    b = torch.sum(cross(plane1, plane2) * pos_ji, dim=-1) / dist_safe
    phi = fold(torch.atan2(b, a))
    # where the edge is one of the target's two reference vectors, a plane is
    # the cross product of a vector with itself: zero, but for rounding (an
    # FMA leaves a residue whose sign folds phi to 0 or pi); its exact value
    # is atan2(0, 0) = 0
    ar = torch.arange(N, device=pos.device)
    own = (n0[:, :, None] == ar[None, None, :]) | (n1[:, :, None] == ar[None, None, :])
    phi = torch.where(own, torch.zeros_like(phi), phi)

    # tau's reference atoms skip the partner itself (reference comenet.py:412-422)
    iref = n0[:, :, None] == ar[None, None, :]             # n0(t) == s
    pos_iref = torch.where(iref[..., None], pos_in1, pos_in0)
    jref_is_t = n0[:, None, :] == ar[None, :, None]        # n0(s) == t
    v0_s = v0[:, None, :, :].expand(-1, N, -1, -1)
    v1_s = v1[:, None, :, :].expand(-1, N, -1, -1)
    pos_jref = -torch.where(jref_is_t[..., None], v1_s, v0_s)
    plane1 = cross(pos_ji, pos_jref)
    plane2 = cross(pos_ji, pos_iref)
    a = torch.sum(plane1 * plane2, dim=-1)
    b = torch.sum(cross(plane1, plane2) * pos_ji, dim=-1) / dist_safe
    tau = fold(torch.atan2(b, a))
    # where both ends take the same reference atom, plane1 = -plane2: b is
    # zero but for rounding, whose sign would fold tau to 0 or pi at random;
    # its exact value is pi
    iref_atom = torch.where(iref, n1[:, :, None], n0[:, :, None])
    jref_atom = torch.where(jref_is_t, n1[:, None, :], n0[:, None, :])
    tau = torch.where(iref_atom == jref_atom, torch.full_like(tau, math.pi), tau)
    return dist, theta, phi, tau


class EdgeGraphConv(nn.Module):
    """Attention-gated edge conv (reference comenet.py:148-223): the message
    along (s -> t) is ``x_s * ew[t, s]``, gated by a sigmoid attention,
    summed at t, then ``lin_rel(agg) + lin_root(x)``."""

    def __init__(self, hidden: int):
        super().__init__()
        self.edge_lin_1 = Dense(hidden, hidden)
        self.edge_lin_2 = Dense(hidden, hidden)
        self.edge_attn_1 = Dense(hidden, 1)
        self.lin_rel = Dense(hidden, hidden)
        self.lin_root = Dense(hidden, hidden, bias=False)

    def forward(self, x, edge_attr, emask):
        ew = linear(self.edge_lin_2, F.silu(linear(self.edge_lin_1, edge_attr)))
        msg = x[:, None, :, :] * ew                             # (B, t, s, H)
        attn = torch.sigmoid(linear(self.edge_attn_1, msg))
        msg = msg * attn * emask[..., None].to(msg.dtype)
        return linear(self.lin_rel, torch.sum(msg, dim=2)) + linear(self.lin_root, x)


class GraphNorm(nn.Module):
    """Masked per-graph GraphNorm with learnable ``alpha``, ``gamma`` and
    ``beta``."""

    def __init__(self, hidden: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.alpha = nn.Parameter(torch.ones(hidden))
        self.gamma = nn.Parameter(torch.ones(hidden))
        self.beta = nn.Parameter(torch.zeros(hidden))

    def forward(self, x, node_mask):
        m = node_mask[..., None].to(x.dtype)
        cnt = torch.clamp(torch.sum(m, dim=1, keepdim=True), min=1.0)
        mean = torch.sum(x * m, dim=1, keepdim=True) / cnt
        shifted = (x - self.alpha * mean) * m
        var = torch.sum(shifted**2 * m, dim=1, keepdim=True) / cnt
        return self.gamma * shifted / torch.sqrt(var + self.eps) + self.beta


class SimpleInteractionBlock(nn.Module):
    """(reference comenet.py:226-302, the working-call interpretation)."""

    def __init__(self, hidden: int, num_layers: int, dropout: float = 0.1):
        super().__init__()
        self.num_layers = num_layers
        self.drop = nn.Dropout(dropout)
        self.lin = Dense(hidden, hidden)
        self.conv1 = EdgeGraphConv(hidden)
        self.lin1 = Dense(hidden, hidden)
        self.conv2 = EdgeGraphConv(hidden)
        self.lin2 = Dense(hidden, hidden)
        self.lin_cat = Dense(2 * hidden, hidden)
        for i in range(num_layers):
            self.add_module(f"lins_{i}", Dense(hidden, hidden))
        self.norm = GraphNorm(hidden)
        self.final = Dense(hidden, hidden)

    def forward(self, x, attr1, attr2, emask, node_mask):
        act = F.silu
        x = act(linear(self.lin, x))
        h1 = act(linear(self.lin1, self.conv1(x, attr1, emask)))
        h2 = act(linear(self.lin2, self.conv2(x, attr2, emask)))
        h = linear(self.lin_cat, torch.cat([h1, h2], -1)) + x
        for i in range(self.num_layers):
            h = act(self.drop(linear(getattr(self, f"lins_{i}"), h))) + h
        return linear(self.final, self.norm(h, node_mask))


class EdgeCat(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.lin0 = Dense(2 * hidden, hidden)
        self.lin1 = Dense(hidden, hidden)

    def forward(self, v):
        return linear(self.lin1, F.silu(linear(self.lin0, v)))


class ComENetEncoder(nn.Module):
    """(reference comenet.py:457-633): node states, positions, the edge mask
    and the R/P edge types (B, N, N) in; per-node features out, zero on
    padding."""

    def __init__(self, cutoff: float = 8.0, num_layers: int = 4, hidden_channels: int = 256,
                 out_channels: int = 256, num_radial: int = 3, num_spherical: int = 2,
                 num_output_layers: int = 3, dropout: float = 0.1,
                 generator: torch.Generator | None = None):
        super().__init__()
        H = hidden_channels
        self.cutoff, self.num_layers = cutoff, num_layers
        self.num_output_layers = num_output_layers
        self.feature1 = TorsionEmb(num_radial, num_spherical, cutoff)
        self.feature2 = AngleEmb(num_radial, num_spherical, cutoff)
        self.edge_emb = nn.Embedding(100, H)
        self.edge_cat = EdgeCat(H)
        self.lin_feature1 = TwoLayerLinear(num_spherical**2 * num_radial, H, H, dropout)
        self.lin_feature2 = TwoLayerLinear(num_spherical * num_radial, H, H, dropout)
        for i in range(num_layers):
            self.add_module(f"interaction_{i}",
                            SimpleInteractionBlock(H, num_output_layers, dropout))
        for i in range(num_output_layers):
            self.add_module(f"lins_{i}", Dense(H, H))
        self.lin_out = Dense(H, out_channels)
        self._init(generator)

    @torch.no_grad()
    def _init(self, gen) -> None:
        """Glorot-uniform kernels and zero biases, ``lin_out`` all zero, the
        edge embedding uniform in +-sqrt(3), as the JAX module draws them."""
        for m in self.modules():
            if isinstance(m, Dense):
                nn.init.xavier_uniform_(m.weight, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
        self.lin_out.weight.zero_()
        self.edge_emb.weight.uniform_(-math.sqrt(3), math.sqrt(3), generator=gen)

    @classmethod
    def from_config(cls, config, dtype=None, generator=None) -> "ComENetEncoder":
        return cls(cutoff=config.cutoff, num_layers=config.num_convs,
                   hidden_channels=config.hidden_dim, out_channels=config.hidden_dim,
                   num_radial=config.num_radial, num_spherical=config.num_spherical,
                   dropout=config.get("dropout", 0.1), generator=generator)

    def forward(self, z, pos, emask, type_r, type_p, node_mask):
        act = F.silu
        dist, theta, phi, tau = comenet_features(pos, emask, self.cutoff)
        dist = torch.where(emask, dist, torch.full_like(dist, self.cutoff * 2.0))
        emb_r, emb_p = self.edge_emb.weight[type_r], self.edge_emb.weight[type_p]
        g1 = self.lin_feature1(self.feature1(dist, theta, phi))
        attr1 = self.edge_cat(torch.cat([g1 * emb_r, g1 * emb_p], -1))
        g2 = self.lin_feature2(self.feature2(dist, tau))
        attr2 = self.edge_cat(torch.cat([g2 * emb_r, g2 * emb_p], -1))

        x = residual = z
        for i in range(self.num_layers):
            _x = getattr(self, f"interaction_{i}")(x, attr1, attr2, emask, node_mask)
            x = _x + residual
            residual = residual + _x
        for i in range(self.num_output_layers):
            x = act(linear(getattr(self, f"lins_{i}"), x))
        x = linear(self.lin_out, x)
        return x * node_mask[..., None].to(x.dtype)
