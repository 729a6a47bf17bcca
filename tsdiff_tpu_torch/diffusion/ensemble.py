"""Score functions for the sampler: one model, a dense ensemble, and the
offset-packed ensemble.

All position-independent work is done once per batch, when the function is
built: the typed pair structures, each member's node states and bond
embeddings (dense) or its kernel weights stacked on a leading member axis
(packed).

* ``make_score_fn`` — one model's dense ``pos -> (edge_inv, emask, d)``; with
  ``fused_score`` each step is one launch of the fused dense score kernel.
* ``make_ensemble_score_fn`` — the mean over members.  Dense: the
  member-invariant radius mask and distances are built once per step, each
  member's unfused ``score_step`` runs on them, and the scores are averaged.
  With ``fused_score`` it returns the packed path.
* ``make_packed_ensemble_eps_fn`` — each step builds the member-invariant
  packed distances and masks, makes ONE score-kernel launch for all members
  (the int8 kernel when ``score_quant == "int8"``), takes the mean over
  members and chain-rules it to per-atom vectors with ``eq_transform_packed``.
"""

from __future__ import annotations

import torch

from tsdiff_tpu_torch.core.graph import ReactionBatch
from tsdiff_tpu_torch.core.packed import eq_transform_packed


def stack_params(params_list: list[dict]) -> dict[str, torch.Tensor]:
    """Stack compatible name -> tensor dicts along a new leading axis."""
    return {k: torch.stack([p[k] for p in params_list]).contiguous() for k in params_list[0]}


def _precompute_static(model, batch: ReactionBatch):
    with torch.no_grad():
        return model.precompute_static(
            batch.atom_type, batch.r_feat, batch.p_feat, batch.bond_mat, batch.node_mask
        )


def make_score_fn(model, batch: ReactionBatch):
    """Single-model dense score function ``pos -> (edge_inv (B, N, N, 1),
    emask (B, N, N), d (B, N, N))`` with the static features computed once."""
    static = _precompute_static(model, batch)

    @torch.no_grad()
    def score(pos: torch.Tensor):
        edge_inv, edges, d = model.score_step(pos, batch.node_mask, static)
        return edge_inv, edges.mask_global, d

    return score


def make_packed_ensemble_eps_fn(members: list, batch: ReactionBatch):
    """``pos -> node_eq`` (B, N, 3): the member-mean per-atom score before
    clip_norm, marked ``returns_node_eq`` so the sampler skips its dense
    ``eq_transform``.  ``members`` are CondenseEncoderEpsNetwork modules on
    the batch's device, sharing one configuration and working dtype."""
    model = members[0]
    pp = model.precompute_packed_pairs(batch.bond_mat, batch.node_mask)
    with torch.no_grad():
        z = torch.stack([
            m.node_states(batch.atom_type, batch.r_feat, batch.p_feat, batch.node_mask)
            for m in members
        ]).contiguous()
    ops, member_weights = zip(*(m.packed_score_op() for m in members))
    score_op, weights = ops[0], stack_params(list(member_weights))

    @torch.no_grad()
    def node_eq_fn(pos: torch.Tensor) -> torch.Tensor:
        info = model.build_packed_pair_info(pos, batch.node_mask, pp)
        score = score_op(
            weights, z, info.d_in.contiguous(), info.cmask.contiguous(),
            pp.type_r_in, pp.type_p_in, pp.type_r_out, pp.type_p_out,
            num_blocks=model.num_convs,
        ).mean(dim=0)
        return eq_transform_packed(score, pos, info.m_eq, info.d_out)

    node_eq_fn.returns_node_eq = True
    return node_eq_fn


def make_ensemble_score_fn(members: list, batch: ReactionBatch):
    """Mean-of-members score function for ``dynamic_sampling``.  With
    ``fused_score`` members this is the offset-packed path
    (``make_packed_ensemble_eps_fn``): the same contract for the sampler, half
    the pair rows.  Otherwise each member's unfused dense ``score_step`` runs
    on the step's shared pair info."""
    model = members[0]
    if model.fused_score:
        return make_packed_ensemble_eps_fn(members, batch)
    statics = [_precompute_static(m, batch) for m in members]
    pairs = statics[0].pairs

    @torch.no_grad()
    def score(pos: torch.Tensor):
        pair_info = model.build_pair_info(pos, batch.node_mask, pairs)
        edge_inv = torch.stack([
            m.score_step(pos, batch.node_mask, st, pair_info)[0]
            for m, st in zip(members, statics)
        ]).mean(dim=0)
        _, _, edges_out, d_out = pair_info
        return edge_inv, edges_out.mask_global, d_out

    return score
