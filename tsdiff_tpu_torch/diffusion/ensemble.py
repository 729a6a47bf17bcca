"""Ensemble score of M condensed-encoder members, offset-packed.

All position-independent work is done once per batch: the packed pair
structures, each member's node states z (stacked to (M, B, N, H)) and the
members' kernel weights (stacked on a leading member axis and cast to the
working dtype).  Each sampling step then builds the member-invariant packed
distances and masks, makes ONE score-kernel launch for all members, takes
the mean over members and chain-rules it to per-atom vectors with
``eq_transform_packed``.
"""

from __future__ import annotations

import torch

from tsdiff_tpu_torch.core.graph import ReactionBatch
from tsdiff_tpu_torch.core.packed import eq_transform_packed
from tsdiff_tpu_torch.ops.packed_score import packed_score


def stack_params(params_list: list[dict]) -> dict[str, torch.Tensor]:
    """Stack compatible name -> tensor dicts along a new leading axis."""
    return {k: torch.stack([p[k] for p in params_list]).contiguous() for k in params_list[0]}


def make_packed_ensemble_eps_fn(members: list, batch: ReactionBatch):
    """``pos -> node_eq`` (B, N, 3): the member-mean per-atom score before
    clip_norm.  ``members`` are CondenseEncoderEpsNetwork modules on the
    batch's device, sharing one configuration and working dtype."""
    model = members[0]
    pp = model.precompute_packed_pairs(batch.bond_mat, batch.node_mask)
    with torch.no_grad():
        z = torch.stack([
            m.node_states(batch.atom_type, batch.r_feat, batch.p_feat, batch.node_mask)
            for m in members
        ]).contiguous()
    weights = stack_params([m.kernel_weights() for m in members])

    @torch.no_grad()
    def node_eq_fn(pos: torch.Tensor) -> torch.Tensor:
        info = model.build_packed_pair_info(pos, batch.node_mask, pp)
        score = packed_score(
            weights, z, info.d_in.contiguous(), info.cmask.contiguous(),
            pp.type_r_in, pp.type_p_in, pp.type_r_out, pp.type_p_out,
            num_blocks=model.num_convs,
        ).mean(dim=0)
        return eq_transform_packed(score, pos, info.m_eq, info.d_out)

    return node_eq_fn
