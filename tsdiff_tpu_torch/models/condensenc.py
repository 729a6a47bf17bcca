"""CondenseEncoderEpsNetwork — the transition-state score network.

Structure (hidden H = 256 in the trained checkpoints):

  node state   z = concat[atom_emb(Z) + feat_emb(r_feat),
                          feat_emb(p_feat) - feat_emb(r_feat)]   (B,N,H)
  edges        condensed R/P extension at ``edge_order`` + radius graph
  edge attr    edge_cat(concat[e(d, type_r), e(d, type_p)]), e the edge
               encoder: d_emb(d) * bond_emb(type) (mlp) or
               concat[RBF(d), bond_emb(type)] (gaussian)
  encoder      L SchNet interaction blocks over the global edge set, or
               DimeNet++ (``encoder.name: dimenetpp``) over it: node states,
               positions, the edge set and edge attr in, node states out
  head         re-extended at ``pred_edge_order``, then
               edge_inv = grad_dist_mlp(concat[h_i * h_j, edge_attr])

Parameters carry the checkpoint's names (``tsdiff_tpu_torch.convert``) and
stay float32; each use casts them to the working dtype.  Two paths:

* training and the dense score (``forward`` = ``precompute_static`` +
  ``score_step``): plain torch around the SchNet stack, which with
  ``use_pallas`` is the fused CUDA op ``ops.schnet_stack`` with its own
  backward; with ``fused_score`` the whole of ``score_step`` after the
  distances and masks is the inference-only fused op ``ops.condensed_score``;
* sampling (``score_step_packed``): the offset-packed fused score step
  ``ops.packed_score``, or with ``score_quant="int8"`` its quantized variant
  ``ops.packed_score_int8``;
* packed training (``score_step_packed_xla``, the objective's ``packed_train``
  branch): the differentiable offset-packed forward ``ops.packed_score_xla``
  in torch ops, on the module's own parameters.

Every configuration the JAX model accepts builds: the mlp or gaussian edge
encoder, a hard or smooth (cosine) cutoff, any activation of
``models.activations``.  The three kernel paths (the fused dense score, the
packed sampling score and the packed training forward) need the trained
configuration, mlp with swish and the hard cutoff, and refuse any other, as
the JAX model asserts it on the same paths.  With ``use_pallas`` the
training path runs B3 on whatever cutoff mask the encoder gives, the smooth
cutoff's fractional one included.

The encoder is built by name from the model config's ``encoder``:
``schnet`` (every path above) or ``dimenetpp`` (``models/dimenetpp.py``,
the dense path only, in training and sampling: ``DenseEnsemble``).  The
fused, packed and B3 paths and ``score_quant`` are SchNet's kernels, and a
model with another encoder refuses them, naming its encoder.  DimeNet++
takes the same node states and the encoder order's ``edge_attr`` (its
radial embedding's modulation, so its width is the wrapper's), and the
positions; under a bf16 network its linear layers take bf16 inputs and the
rest of it runs in float32.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from tsdiff_tpu_torch.core.geometry import pairwise_distance
from tsdiff_tpu_torch.core.graph_ops import (
    GraphEdges,
    StaticPairs,
    precompute_static_pairs,
    radius_edge_mask,
)
from tsdiff_tpu_torch.core.packed import (
    PackedPairs,
    half_last_slab_mask,
    pack_static_pairs,
    packed_distance,
    packed_valid_mask,
)
from tsdiff_tpu_torch.models.activations import activation_loader
from tsdiff_tpu_torch.models.edge import make_edge_encoder
from tsdiff_tpu_torch.models.init import init_params_
from tsdiff_tpu_torch.models.mlp import MLP, linear
from tsdiff_tpu_torch.models.schnet import SchNetEncoder
from tsdiff_tpu_torch.ops.condensed_score import condensed_score, extract_weights, with_wg_image
from tsdiff_tpu_torch.ops.packed_score import (
    extract_weights_packed,
    packed_score,
    with_wg_images,
)
from tsdiff_tpu_torch.ops.packed_score_int8 import (
    cast_unquantized,
    extract_weights_packed_int8,
    packed_score_int8,
    with_wg_images_int8,
)
from tsdiff_tpu_torch.ops.packed_score_xla import packed_score_xla

NUM_ATOM_TYPES = 100  # atomic-number embedding table size


class PackedPairInfo(NamedTuple):
    """Member-invariant per-step quantities in offset-packed layout."""

    d_in: torch.Tensor    # (B, K, N) masked distances, encoder edge set
    cmask: torch.Tensor   # (B, K, N) float cutoff & encoder mask & 0.5-last-slab
    d_out: torch.Tensor   # (B, K, N) masked distances, output-head edge set
    m_eq: torch.Tensor    # (B, K, N) float output mask & 0.5-last-slab


@dataclasses.dataclass(frozen=True)
class StaticFeatures:
    """Position-independent features of a batch: the node states and the
    bond-type embeddings of both edge orders, in the working dtype."""

    z: torch.Tensor          # (B, N, H)
    pairs: StaticPairs
    emb_r_in: torch.Tensor   # (B, N, N, H) encoder edge order
    emb_p_in: torch.Tensor
    emb_r_out: torch.Tensor  # (B, N, N, H) output-head edge order
    emb_p_out: torch.Tensor
    #: the fused dense score's weights in the working dtype (``fused_score``
    #: models only): extracted once per batch, not once per step
    fused_weights: dict | None = None


def _check_dense_encoder(enc, hidden_dim: int, **paths) -> None:
    """Refuse an encoder other than SchNet that the condensed network cannot
    run, or a SchNet-only path (the kernels, ``score_quant``) set with it."""
    if enc.name != "dimenetpp":
        raise NotImplementedError(f"unsupported encoder {enc.name} for condensenc")
    if enc.hidden_dim != hidden_dim:
        raise ValueError(f"the {enc.name} encoder's hidden_dim {enc.hidden_dim} must be the "
                         f"network's {hidden_dim}: edge_attr modulates its radial embedding")
    for name, value in paths.items():
        if value not in (False, None, "none"):
            raise ValueError(f"{name} runs SchNet's kernels; this model's encoder is {enc.name}")


class EdgeCat(nn.Module):
    """2-layer fusion MLP of the concatenated R/P edge embeddings."""

    def __init__(self, channels: int, activation: str = "swish"):
        super().__init__()
        self.lin0 = nn.Linear(2 * channels, channels)
        self.lin1 = nn.Linear(channels, channels)
        self.act = activation_loader(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.lin1, self.act(linear(self.lin0, x)))


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
        use_pallas: bool = False,
        fused_score: bool = False,
        packed_train: bool = False,
        score_quant: str | None = None,
        dtype: torch.dtype | None = None,
        generator: torch.Generator | None = None,
        encoder_config=None,
    ):
        """``use_pallas`` runs the SchNet stack through the fused CUDA op
        (its plain twin on CPU tensors); ``fused_score`` runs ``score_step``
        through the inference-only fused dense score op and makes an ensemble
        take the packed path; ``score_quant="int8"`` picks the packed path's
        int8 op; ``packed_train`` makes the objective train through the
        differentiable packed forward ``score_step_packed_xla``.
        ``encoder_config``: the model config's ``encoder`` for an encoder
        other than SchNet (``dimenetpp``), which then replaces the SchNet
        stack of ``num_convs``, ``cutoff``, ``smooth_conv``.
        Parameters are initialised from ``generator``
        (``models.init``; DimeNet++'s by its own initialisers)."""
        super().__init__()
        if hidden_dim % 2:
            raise ValueError("hidden_dim must be even")
        self.encoder_name = "schnet" if encoder_config is None else encoder_config.name
        if self.encoder_name != "schnet":
            _check_dense_encoder(encoder_config, hidden_dim, use_pallas=use_pallas,
                                 fused_score=fused_score, packed_train=packed_train,
                                 score_quant=score_quant)
        self.hidden_dim = hidden_dim
        self.edge_order = edge_order
        self.pred_edge_order = pred_edge_order
        self.edge_cutoff = edge_cutoff
        self.num_convs = num_convs
        self.cutoff = cutoff
        self.use_pallas = use_pallas
        self.fused_score = fused_score
        self.packed_train = packed_train
        self.score_quant = score_quant
        self.dtype = dtype or torch.float32
        self.edge_encoder = edge_encoder
        self.mlp_act, self.edge_cat_act = mlp_act, edge_cat_act
        half = hidden_dim // 2
        self.atom_embedding = nn.Embedding(NUM_ATOM_TYPES, half)
        self.atom_feat_embedding = nn.Linear(feat_dim, half, bias=False)
        self.edge_enc = make_edge_encoder(edge_encoder, hidden_dim, mlp_act, cutoff)
        self.edge_cat = EdgeCat(self.edge_enc.out_channels, edge_cat_act)
        if encoder_config is None:
            self.encoder = SchNetEncoder(
                hidden_channels=hidden_dim, num_filters=hidden_dim, num_interactions=num_convs,
                cutoff=cutoff, smooth=smooth_conv, use_pallas=use_pallas,
            )
        else:
            from tsdiff_tpu_torch.models.dimenetpp import DimeNetPPEncoder

            self.encoder = DimeNetPPEncoder.from_config(encoder_config)
            self.num_convs, self.cutoff = self.encoder.num_layers, self.encoder.cutoff
        self.grad_dist_mlp = MLP(2 * hidden_dim, [hidden_dim, hidden_dim // 2, 1], mlp_act)
        init_params_(self, generator)
        if encoder_config is not None:
            self.encoder._init(generator)   # glorot_orthogonal, not init_params_'s uniform

    @classmethod
    def from_config(cls, config, dtype=None, generator=None) -> "CondenseEncoderEpsNetwork":
        """Build from a model config, as checkpoints embed it."""
        enc = config.encoder
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
            smooth_conv=enc.smooth_conv if enc.name == "schnet" else False,
            use_pallas=config.get("use_pallas", False),
            fused_score=config.get("fused_score", False),
            packed_train=config.get("packed_train", False),
            score_quant=config.get("score_quant", None),
            dtype=dtype,
            generator=generator,
            encoder_config=None if enc.name == "schnet" else enc,
        )

    def require_kernel_configuration(self, path: str) -> None:
        """Raise ``ValueError`` unless this model has the configuration the
        kernel paths compute: the SchNet encoder, the mlp edge encoder,
        swish activations and the hard cutoff (the JAX model asserts the
        same on these paths)."""
        if self.encoder_name != "schnet":
            raise ValueError(f"the {path} needs the SchNet encoder; this model's encoder is "
                             f"{self.encoder_name}")
        if self.edge_encoder != "mlp":
            raise ValueError(f"the {path} needs the mlp edge encoder")
        if self.encoder.smooth:
            raise ValueError(f"the {path} needs the hard cutoff")
        if self.mlp_act != "swish" or self.edge_cat_act != "swish":
            raise ValueError(f"the {path} needs swish activations")

    def node_states(self, atom_type, r_feat, p_feat, node_mask) -> torch.Tensor:
        """Condensed node states z = [a + af_r, af_p - af_r] (B, N, H) in the
        working dtype; position-independent.  Products accumulate in float32
        from working-dtype operands and round once."""
        dt = self.dtype
        a_emb = F.embedding(atom_type, self.atom_embedding.weight.to(dt))
        w = self.atom_feat_embedding.weight.to(dt).float()
        af_r = F.linear(r_feat.to(dt).float(), w).to(dt)
        af_p = F.linear(p_feat.to(dt).float(), w).to(dt)
        z = torch.cat([a_emb + af_r, af_p - af_r], dim=-1)
        return z * node_mask[..., None].to(dt)

    # ---- dense path (training) ----

    def precompute_pairs(self, bond_mat, node_mask) -> StaticPairs:
        """Position-independent typed edge structures of both edge orders."""
        return precompute_static_pairs(bond_mat, node_mask, self.edge_order, self.pred_edge_order)

    def build_pair_info(self, pos, node_mask, static: StaticPairs):
        """``(edges_in, d_in, edges_out, d_out)``: the static local sets united
        with the radius graph on ``pos``, and masked distances.  The output
        order's distances reuse the input order's (its edge set is a subset
        of the input set united with the same radius mask)."""
        mask_radius = radius_edge_mask(pos, node_mask, self.edge_cutoff)
        edges_in = GraphEdges(
            mask_global=static.mask_local_in | mask_radius,
            mask_local=static.mask_local_in,
            type_r=static.type_r_in,
            type_p=static.type_p_in,
        )
        d_in = pairwise_distance(pos, edges_in.mask_global)
        if self.pred_edge_order == self.edge_order:
            return edges_in, d_in, edges_in, d_in
        edges_out = GraphEdges(
            mask_global=static.mask_local_out | mask_radius,
            mask_local=static.mask_local_out,
            type_r=static.type_r_out,
            type_p=static.type_p_out,
        )
        d_out = torch.where(edges_out.mask_global, d_in, torch.ones_like(d_in))
        return edges_in, d_in, edges_out, d_out

    def precompute_static(self, atom_type, r_feat, p_feat, bond_mat, node_mask) -> StaticFeatures:
        """All position-independent work of the dense forward."""
        pairs = self.precompute_pairs(bond_mat, node_mask)
        emb = self.edge_enc.bond_embedding
        return StaticFeatures(
            z=self.node_states(atom_type, r_feat, p_feat, node_mask),
            pairs=pairs,
            emb_r_in=emb(pairs.type_r_in, self.dtype),
            emb_p_in=emb(pairs.type_p_in, self.dtype),
            emb_r_out=emb(pairs.type_r_out, self.dtype),
            emb_p_out=emb(pairs.type_p_out, self.dtype),
            fused_weights=self.fused_weights() if self.fused_score else None,
        )

    def fused_weights(self) -> dict[str, torch.Tensor]:
        """The fused dense score's weights in the working dtype, with the
        matrices arranged once more as the warp-specialised kernel's tile
        images (``WG_IMAGE``) where a kernel takes them: bfloat16 at H = 256."""
        self.require_kernel_configuration("fused score")
        w = extract_weights(self.state_dict())
        w = {k: v.to(self.dtype).contiguous() for k, v in w.items()}
        if self.dtype == torch.bfloat16 and w["dw1"].shape[-1] == 256:
            w = with_wg_image(w)
        return w

    def edge_attr(self, d_emb, emb_r, emb_p) -> torch.Tensor:
        """``edge_cat`` of the R and P edge embeddings (B, N, N, H)."""
        combine = self.edge_enc.combine
        return self.edge_cat(torch.cat([combine(d_emb, emb_r), combine(d_emb, emb_p)], dim=-1))

    def score_step(self, pos, node_mask, static: StaticFeatures, pair_info=None,
                   fused: bool | None = None):
        """Position-dependent part of the dense forward: ``(edge_inv (B, N,
        N, 1) float32, edges at pred_edge_order, d_out)``.  The distance MLP
        runs once on the encoder-order distances and is shared with the
        output stage.  ``fused`` (default: the model's ``fused_score``) runs
        everything after the distances and masks in the fused dense score op,
        which has no gradient; its off-edge entries differ from the unfused
        path's and are masked by every caller."""
        dt = self.dtype
        if pair_info is None:
            pair_info = self.build_pair_info(pos, node_mask, static.pairs)
        edges_in, d_in, edges_out, d_out = pair_info

        if self.fused_score if fused is None else fused:
            if torch.is_grad_enabled() and any(p.requires_grad for p in self.parameters()):
                raise NotImplementedError(
                    "fused_score=True uses the inference-only fused score kernel, which "
                    "has no gradient. Training/get_loss must run the unfused path: call "
                    "under torch.no_grad() for inference, or construct the model with "
                    "fused_score=False (tsdiff_tpu_torch.diffusion.objective."
                    "diffusion_loss takes the unfused path automatically)."
                )
            cmask = ((d_in <= self.cutoff) & edges_in.mask_global).to(torch.float32)
            edge_inv = condensed_score(
                static.fused_weights or self.fused_weights(), static.z.contiguous(),
                d_in.contiguous(), cmask, static.emb_r_in, static.emb_p_in,
                static.emb_r_out, static.emb_p_out, num_blocks=self.num_convs,
            )
            return edge_inv, edges_out, d_out
        d_emb = self.edge_enc.d_embedding(d_in.to(dt)[..., None])
        ea = self.edge_attr(d_emb, static.emb_r_in, static.emb_p_in)
        if self.encoder_name == "schnet":
            node_attr = self.encoder(static.z, ea, d_in, edges_in.mask_global, dt)
        else:
            node_attr = self.encoder(static.z.float(), pos.float(), edges_in.mask_global,
                                     ea.float(), node_mask, dtype=dt).to(dt)
        if self.pred_edge_order != self.edge_order:
            ea = self.edge_attr(d_emb, static.emb_r_out, static.emb_p_out)
        h_pair = torch.cat([node_attr[:, :, None, :] * node_attr[:, None, :, :], ea], dim=-1)
        return self.grad_dist_mlp(h_pair).float(), edges_out, d_out

    def forward(self, atom_type, r_feat, p_feat, pos, bond_mat, node_mask,
                fused: bool | None = None):
        """Score-network forward: ``precompute_static`` then ``score_step``."""
        static = self.precompute_static(atom_type, r_feat, p_feat, bond_mat, node_mask)
        return self.score_step(pos, node_mask, static, fused=fused)

    # ---- offset-packed path (sampling) ----

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

    def packed_score_op(self):
        """``(op, weights)`` of the packed score step: the op this model's
        ``score_quant`` picks and this member's weights for it."""
        self.require_kernel_configuration("packed score")
        if self.score_quant == "int8":
            return packed_score_int8, self.kernel_weights_int8()
        if self.score_quant is not None:
            raise ValueError(f"unknown score_quant {self.score_quant!r}")
        return packed_score, self.kernel_weights()

    def kernel_weights(self) -> dict[str, torch.Tensor]:
        """This member's score-kernel weights in the working dtype, with the
        matrices arranged once more as the warp-specialised kernel's tile
        images (``WG_IMAGE``) and f2w as its filter chain's K-blocks
        (``WG_IMAGE_F2K``) where a kernel takes them: bfloat16 at H = 256."""
        w = extract_weights_packed(self.state_dict())
        w = {k: v.to(self.dtype).contiguous() for k, v in w.items()}
        if self.dtype == torch.bfloat16 and w["dw1"].shape[-1] == 256:
            w = with_wg_images(w)
        return w

    def kernel_weights_int8(self) -> dict[str, torch.Tensor]:
        """This member's int8 score-kernel weights: codes and scales from the
        float32 parameters, the unquantized rest in the working dtype, and
        where a kernel takes them (bfloat16 at H = 256) the matrices arranged
        once more as the warp-specialised kernel's tile images."""
        w = cast_unquantized(extract_weights_packed_int8(self.state_dict()), self.dtype)
        if self.dtype == torch.bfloat16 and w["dw1"].shape[-1] == 256:
            w = with_wg_images_int8(w)
        return w

    @torch.no_grad()
    def score_step_packed(self, pos, node_mask, z, pp: PackedPairs, pair_info=None):
        """Packed ``edge_inv`` (B, K, N) float32 of this one model.  Chain-rule
        with ``core.packed.eq_transform_packed(out, pos, info.m_eq, info.d_out)``."""
        if pair_info is None:
            pair_info = self.build_packed_pair_info(pos, node_mask, pp)
        op, weights = self.packed_score_op()
        w = {k: v[None] for k, v in weights.items()}
        out = op(
            w, z[None].contiguous(), pair_info.d_in.contiguous(), pair_info.cmask.contiguous(),
            pp.type_r_in, pp.type_p_in, pp.type_r_out, pp.type_p_out,
            num_blocks=self.num_convs,
        )
        return out[0]

    # ---- offset-packed path (training) ----

    def packed_xla_weights(self) -> dict[str, torch.Tensor]:
        """The packed forward's weights as views of this module's parameters
        (gradients reach them), in the XLA twin's names and (in, out) layout."""
        H = self.hidden_dim
        c0w = self.edge_cat.lin0.weight            # (H, 2H)
        g0w = self.grad_dist_mlp.layers[0].weight  # (H, 2H)
        d_mlp, head = self.edge_enc.mlp.layers, self.grad_dist_mlp.layers
        return dict(
            dw0=d_mlp[0].weight.t(), db0=d_mlp[0].bias,
            dw1=d_mlp[1].weight.t(), db1=d_mlp[1].bias,
            table=self.edge_enc.bond_emb.weight,
            c0r=c0w[:, :H].t(), c0p=c0w[:, H:].t(), c0b=self.edge_cat.lin0.bias,
            c1w=self.edge_cat.lin1.weight.t(), c1b=self.edge_cat.lin1.bias,
            **self.encoder.stack.weights(),
            g0h=g0w[:, :H].t(), g0e=g0w[:, H:].t(), g0b=head[0].bias,
            g1w=head[1].weight.t(), g1b=head[1].bias,
            g2w=head[2].weight.t(), g2b=head[2].bias,
        )

    def score_step_packed_xla(self, pos, node_mask, z, pp: PackedPairs, pair_info=None):
        """Differentiable packed score ``(edge_inv (B, K, N) float32,
        PackedPairInfo)`` (``ops.packed_score_xla``): the packed training
        forward, with the gradient of every parameter.  Needs the mlp edge
        encoder, swish and the hard cutoff, as the JAX package's."""
        self.require_kernel_configuration("packed score")
        if pair_info is None:
            pair_info = self.build_packed_pair_info(pos, node_mask, pp)
        score = packed_score_xla(
            self.packed_xla_weights(), z, pair_info.d_in, pair_info.cmask,
            pp.type_r_in, pp.type_p_in, pp.type_r_out, pp.type_p_out,
            num_blocks=self.num_convs, dtype=self.dtype,
        )
        return score, pair_info
