"""DimeNet++ encoder on the dense pair grid (an optional encoder).

Port of ``tsdiff_tpu/models/dimenetpp.py``: directional message passing
over edge triplets (k -> j -> i).  Edge states ``E[b, i, j, :]`` hold the
directed edge (j -> i); triplet tensors are indexed (i, j, k).  A triplet
is valid where ``emask[i, j] & emask[k, j] & (k != i)``, and the scatter
over ``idx_ji`` is a masked contraction over k.  The (ns * nr) triplet
basis is never built: the ``lin_sbf1`` projection is folded into the
radial and angular factors, as in the JAX module.  The triplet tensors are
O(B N^3): molecule-sized graphs only.

The Bessel and harmonic factors are ``ops/basis.py``'s, evaluated without
sympy.  Linear layers are ``Dense`` (a flax ``nn.Dense`` each, initialised
``glorot_orthogonal`` where the JAX module does), named as the JAX
parameters, so ``tsdiff_tpu_torch.convert`` moves weights both ways.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tsdiff_tpu_torch.models.mlp import Dense, linear
from tsdiff_tpu_torch.ops.basis import bessel_basis, real_sph_harm


@torch.no_grad()
def glorot_orthogonal_(w: torch.Tensor, scale: float = 2.0,
                       generator: torch.Generator | None = None) -> torch.Tensor:
    """An orthogonal draw rescaled to the glorot variance ``scale * 2 /
    (fan_in + fan_out)`` (torch_geometric's ``glorot_orthogonal``), in
    place."""
    nn.init.orthogonal_(w, generator=generator)
    target_var = scale * 2.0 / (w.shape[0] + w.shape[-1])
    return w.mul_(torch.sqrt(target_var / (torch.var(w, unbiased=False) + 1e-12)))


def _glin(in_dim: int, out_dim: int, bias: bool = True) -> Dense:
    layer = Dense(in_dim, out_dim, bias=bias)
    layer.glorot_orthogonal = True
    return layer


def envelope(x: torch.Tensor, exponent: int = 5) -> torch.Tensor:
    """Smooth cutoff polynomial, zero from x = 1 on (reference
    dimenetpp_features.py:149-164)."""
    p = exponent + 1
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2)
    c = -p * (p + 1) / 2.0
    xp0 = x ** (p - 1)
    out = 1.0 / torch.clamp(x, min=1e-12) + a * xp0 + b * xp0 * x + c * xp0 * x * x
    return out * (x < 1.0)


class DistEmb(nn.Module):
    """Enveloped sine radial basis with learnable frequencies ``freq``,
    initialised ``pi * (1 .. num_radial)``."""

    def __init__(self, num_radial: int, cutoff: float = 5.0, envelope_exponent: int = 5):
        super().__init__()
        self.cutoff, self.envelope_exponent = cutoff, envelope_exponent
        self.freq = nn.Parameter(torch.arange(1, num_radial + 1, dtype=torch.float32) * math.pi)

    def forward(self, dist: torch.Tensor) -> torch.Tensor:
        x = dist[..., None] / self.cutoff
        return envelope(x, self.envelope_exponent) * torch.sin(self.freq * x)


class ResidualLayer(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.lin1 = _glin(hidden, hidden)
        self.lin2 = _glin(hidden, hidden)

    def forward(self, x):
        return x + F.silu(linear(self.lin2, F.silu(linear(self.lin1, x))))


class DimeNetPPEncoder(nn.Module):
    """(reference dimenetpp.py:293-444): node states ``z`` (or atom types
    with ``embed_node``, for a module built with it), positions, the
    directed-edge mask and a per-edge modulation ``edge_attr`` in; per-node
    features out, zero on padding."""

    def __init__(self, num_layers: int = 4, hidden_channels: int = 128, out_channels: int = 128,
                 int_emb_size: int = 64, basis_emb_size: int = 8, out_emb_channels: int = 256,
                 num_spherical: int = 7, num_radial: int = 6, cutoff: float = 5.0,
                 envelope_exponent: int = 5, num_before_skip: int = 1, num_after_skip: int = 2,
                 num_output_layers: int = 3, embed_node: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        H, I, Bb = hidden_channels, int_emb_size, basis_emb_size
        ns, nr = num_spherical, num_radial
        self.num_layers, self.cutoff = num_layers, cutoff
        self.num_spherical, self.num_radial = ns, nr
        self.envelope_exponent = envelope_exponent
        self.num_before_skip, self.num_after_skip = num_before_skip, num_after_skip
        self.num_output_layers = num_output_layers
        if embed_node:  # the JAX module makes its table only when it embeds
            self.emb = nn.Embedding(95, H)
        self.dist_emb = DistEmb(nr, cutoff, envelope_exponent)
        self.lin_sbf1 = nn.Parameter(torch.empty(ns * nr, Bb))  # flax (in, out) layout
        self.lin_sbf2 = _glin(Bb, I, bias=False)
        self.init_lin_rbf_0 = Dense(nr, H)
        self.init_lin = Dense(3 * H, H)
        self.init_lin_rbf_1 = _glin(nr, H, bias=False)
        self._output_block("v_init", H, out_emb_channels, out_channels)
        for layer in range(num_layers):
            t = f"e{layer}"
            for name, a, b, bias in (("lin_ji", H, H, True), ("lin_kj", H, H, True),
                                     ("lin_rbf1", nr, Bb, False), ("lin_rbf2", Bb, H, False),
                                     ("lin_down", H, I, False), ("lin_up", I, H, False),
                                     ("lin", H, H, True), ("lin_rbf", nr, H, False)):
                self.add_module(f"{t}_{name}", _glin(a, b, bias))
            for ri in range(num_before_skip):
                self.add_module(f"{t}_res_before_{ri}", ResidualLayer(H))
            for ri in range(num_after_skip):
                self.add_module(f"{t}_res_after_{ri}", ResidualLayer(H))
            self._output_block(f"v{layer}", H, out_emb_channels, out_channels)
        self._init(generator)

    def _output_block(self, tag: str, H: int, out_emb: int, out: int) -> None:
        self.add_module(f"{tag}_lin_up", _glin(H, out_emb))
        for li in range(self.num_output_layers):
            self.add_module(f"{tag}_lins_{li}", _glin(out_emb, out_emb))
        self.add_module(f"{tag}_lin", _glin(out_emb, out, bias=False))

    @torch.no_grad()
    def _init(self, gen) -> None:
        """The JAX module's initialisers: ``glorot_orthogonal`` with zero
        biases for the ``_glin`` layers and ``lin_sbf1``, flax's default
        (LeCun normal, zero bias) for the other two, the embedding uniform
        in +-sqrt(3)."""
        for m in self.modules():
            if isinstance(m, Dense):
                if getattr(m, "glorot_orthogonal", False):
                    glorot_orthogonal_(m.weight, 2.0, gen)
                else:  # lecun_normal: a normal truncated at 2 sigma, variance 1 / fan_in
                    nn.init.trunc_normal_(m.weight, 0.0, 1.0, -2.0, 2.0, generator=gen)
                    m.weight.mul_(1.0 / 0.87962566103423978 / math.sqrt(m.in_features))
                if m.bias is not None:
                    m.bias.zero_()
        glorot_orthogonal_(self.lin_sbf1, 2.0, gen)
        if hasattr(self, "emb"):
            self.emb.weight.uniform_(-math.sqrt(3), math.sqrt(3), generator=gen)

    @classmethod
    def from_config(cls, config, dtype=None, generator=None) -> "DimeNetPPEncoder":
        return cls(num_layers=config.num_convs, hidden_channels=config.hidden_dim,
                   out_channels=config.hidden_dim, cutoff=config.cutoff,
                   num_radial=config.num_radial, num_spherical=config.num_spherical,
                   num_before_skip=config.num_before_skip, num_after_skip=config.num_after_skip,
                   generator=generator)

    @staticmethod
    def _angles(pos: torch.Tensor) -> torch.Tensor:
        """``A[b, i, j, k]``: the angle at j between (j -> i) and (j -> k)
        (reference dimenetpp.py:53-58)."""
        vec = pos[:, :, None, :] - pos[:, None, :, :]        # vec[i, j] = pos_i - pos_j
        v_ji = vec[:, :, :, None, :]
        v_jk = vec.transpose(1, 2)[:, None, :, :, :]
        dot = torch.sum(v_ji * v_jk, dim=-1)
        cross = torch.linalg.cross(*torch.broadcast_tensors(v_ji, v_jk), dim=-1)
        return torch.atan2(torch.linalg.norm(cross, dim=-1), dot)

    def forward(self, z, pos, emask, edge_attr, node_mask=None, embed_node: bool = False):
        ns, nr = self.num_spherical, self.num_radial
        act = F.silu
        if embed_node:
            z = self.emb.weight[z]  # built with embed_node=True
        n = pos.shape[1]
        diff = pos[:, :, None, :] - pos[:, None, :, :]
        dist = torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=-1), min=1e-12))
        dist = torch.where(emask, dist, torch.full_like(dist, self.cutoff * 2.0))
        rbf = self.dist_emb(dist)

        # the triplet basis, lin_sbf1 folded into its factors
        x_scaled = dist / self.cutoff
        rbf_bes = bessel_basis(ns, nr, x_scaled) * envelope(x_scaled, self.envelope_exponent)[..., None]
        rbf_bes = rbf_bes.reshape(*dist.shape, ns, nr)       # edge (k -> j) at [j, k]
        cbf = real_sph_harm(ns, self._angles(pos))             # (B, i, j, k, ns)
        rw = torch.einsum("bjkln,lnc->bjklc", rbf_bes, self.lin_sbf1.reshape(ns, nr, -1))
        sbf2 = linear(self.lin_sbf2, torch.einsum("bijkl,bjklc->bijkc", cbf, rw))
        eye = torch.eye(n, dtype=torch.bool, device=pos.device)
        tri_mask = emask[:, :, :, None] & emask.transpose(1, 2)[:, None] & ~eye[None, :, None, :]
        sbf2 = sbf2 * tri_mask[..., None]
        em = emask[..., None].to(rbf.dtype)

        # init block (reference dimenetpp.py:129-160)
        rbf0 = act(linear(self.init_lin_rbf_0, rbf))
        rbf0 = edge_attr * rbf0 + edge_attr
        x_i = z[:, :, None, :].expand(-1, -1, n, -1)
        x_j = z[:, None, :, :].expand(-1, n, -1, -1)
        e1 = act(linear(self.init_lin, torch.cat([x_i, x_j, rbf0], -1)))
        e2 = linear(self.init_lin_rbf_1, rbf) * e1

        def update_v(e2_, tag):
            v = torch.sum(e2_ * em, dim=2)
            v = linear(getattr(self, f"{tag}_lin_up"), v)
            for li in range(self.num_output_layers):
                v = act(linear(getattr(self, f"{tag}_lins_{li}"), v))
            return linear(getattr(self, f"{tag}_lin"), v)

        v = update_v(e2, "v_init")
        # interaction blocks (reference dimenetpp.py:163-247)
        for layer in range(self.num_layers):
            lin = lambda name: getattr(self, f"e{layer}_{name}")  # noqa: E731
            x1 = e1
            x_ji = act(linear(lin("lin_ji"), x1))
            x_kj = act(linear(lin("lin_kj"), x1))
            r = linear(lin("lin_rbf2"), linear(lin("lin_rbf1"), rbf))
            x_kj = x_kj * (edge_attr * r)
            x_kj = act(linear(lin("lin_down"), x_kj))
            # T[i, j] = sum_k x_kj[j, k] * sbf2[i, j, k]
            t = torch.einsum("bjkc,bijkc->bijc", x_kj, sbf2)
            e1_new = x_ji + act(linear(lin("lin_up"), t))
            for ri in range(self.num_before_skip):
                e1_new = lin(f"res_before_{ri}")(e1_new)
            e1_new = act(linear(lin("lin"), e1_new)) + x1
            for ri in range(self.num_after_skip):
                e1_new = lin(f"res_after_{ri}")(e1_new)
            e2 = linear(lin("lin_rbf"), rbf) * e1_new
            e1 = e1_new
            v = update_v(e2, f"v{layer}")
        if node_mask is not None:
            v = v * node_mask[..., None].to(v.dtype)
        return v
