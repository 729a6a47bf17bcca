"""Score functions for the sampler: one model, a dense ensemble, and the
offset-packed ensemble, and the loading of an ensemble's members.

All position-independent work is done once per batch: the typed pair
structures, each member's node states and bond embeddings (dense); the
members' kernel weights are stacked on a leading member axis once per
ensemble (packed).

* ``make_score_fn`` — one model's dense ``pos -> (edge_inv, emask, d)``; with
  ``fused_score`` each step is one launch of the fused dense score kernel.
* ``PackedEnsemble`` — each step builds the member-invariant packed
  distances and masks, makes ONE score-kernel launch for all members (the
  int8 kernel when ``score_quant == "int8"``), takes the mean over members
  and chain-rules it to per-atom vectors with ``eq_transform_packed``.
* ``DenseEnsemble`` — the member-invariant radius mask and distances are
  built once per step, each member's unfused ``score_step`` runs on them,
  and the scores are averaged (the SchNet members without ``fused_score``,
  and every member whose encoder is DimeNet++).  Its statics count the
  batch's real and computed pairs and triplets (``DenseStatics.counts``),
  which the dense grid's work scales with.
* On a mesh (``parallel/sharding.py``) each rank holds its block of the
  members (``load_members(..., mesh=)``), and the mean over members is the
  rank's member sum, an ``all_reduce(SUM)`` over the ``ens`` group, then
  ÷ M: what XLA runs for ``jnp.mean(jax.vmap(member)(...), axis=0)`` on an
  ``ens``-sharded stack (``tsdiff_tpu/diffusion/ensemble.py:99``).  The
  partial sums add in another order than one rank's mean (f32 differences
  of ~1e-7 relative).  Without a mesh the mean is ``.mean(dim=0)``.
* Both split into ``prepare(batch)``, the per-batch statics, and
  ``step_fn(statics)``, the per-step function that reads them; the service's
  captured walk keeps the statics in tensors of its own
  (``diffusion/captured.py``).  ``make_packed_ensemble_eps_fn`` and
  ``make_ensemble_score_fn`` (packed for ``fused_score`` members) do both
  for one batch.
* ``DualEnsemble`` — the dual encoder's members: each member's per-atom
  score (``dual_objective.dual_eps``, the global branch clipped) on the
  batch's order-extended bond graph, made once per batch, and the mean over
  members, as the JAX sampling CLI averages its members' eps
  (``tsdiff_tpu/cli/sampling.py:298-305``).  A batch of protein subgraphs
  (``is_sidechain``) restricts the radius graph to sidechain-touching pairs
  and pins the backbone in the walk (``DualStatics.pin``).
* ``load_members`` — the members from checkpoints, as the sampling CLI and
  the service load them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from tsdiff_tpu_torch.core.graph import ReactionBatch
from tsdiff_tpu_torch.core.packed import PackedPairs, eq_transform_packed


def stack_params(params_list: list[dict]) -> dict[str, torch.Tensor]:
    """Stack compatible name -> tensor dicts along a new leading axis."""
    return {k: torch.stack([p[k] for p in params_list]).contiguous() for k in params_list[0]}


def _precompute_static(model, batch: ReactionBatch):
    with torch.no_grad():
        return model.precompute_static(
            batch.atom_type, batch.r_feat, batch.p_feat, batch.bond_mat, batch.node_mask
        )


def member_mean(stack: torch.Tensor, group=None, n_members: int | None = None) -> torch.Tensor:
    """The mean over the leading member axis of ``stack``; with ``group``
    (the ``ens`` axis) over the members of every rank of the group:
    ``n_members`` in all, each rank holding its block."""
    if group is None:
        return stack.mean(dim=0)
    total = stack.sum(dim=0)
    dist.all_reduce(total, group=group)
    return total / n_members


def make_score_fn(model, batch: ReactionBatch):
    """Single-model dense score function ``pos -> (edge_inv (B, N, N, 1),
    emask (B, N, N), d (B, N, N))`` with the static features computed once."""
    static = _precompute_static(model, batch)

    @torch.no_grad()
    def score(pos: torch.Tensor):
        edge_inv, edges, d = model.score_step(pos, batch.node_mask, static)
        return edge_inv, edges.mask_global, d

    return score


@dataclasses.dataclass(frozen=True)
class PackedStatics:
    """Per-batch, position-independent inputs of the packed ensemble's step;
    every tensor is new, none is the batch's own."""

    node_mask: torch.Tensor  # (B, N) bool
    pairs: PackedPairs       # offset-packed typed pair structures
    z: torch.Tensor          # (M, B, N, H) each member's node states


class PackedEnsemble:
    """The offset-packed ensemble score, split where a batch changes: the
    members' kernel weights are stacked once, ``prepare`` makes one batch's
    ``PackedStatics``, and the function of ``step_fn`` reads them on every
    step.  A caller that keeps the statics in tensors of its own (a CUDA
    graph reads fixed addresses) copies each new batch's into them.
    ``group``/``n_members``: the ``ens`` group and the ensemble's size when
    ``members`` are this rank's block of them (``member_mean``)."""

    def __init__(self, members: list, group=None, n_members: int | None = None):
        self.model = members[0]
        self.members = members
        self.group, self.n_members = group, n_members or len(members)
        ops, member_weights = zip(*(m.packed_score_op() for m in members))
        self.score_op, self.weights = ops[0], stack_params(list(member_weights))

    @torch.no_grad()
    def prepare(self, batch: ReactionBatch) -> PackedStatics:
        z = torch.stack([
            m.node_states(batch.atom_type, batch.r_feat, batch.p_feat, batch.node_mask)
            for m in self.members
        ]).contiguous()
        pairs = self.model.precompute_packed_pairs(batch.bond_mat, batch.node_mask)
        return PackedStatics(node_mask=batch.node_mask.clone(), pairs=pairs, z=z)

    def step_fn(self, statics: PackedStatics):
        """``pos -> node_eq`` (B, N, 3): the member-mean per-atom score before
        clip_norm, marked ``returns_node_eq`` so the sampler skips its dense
        ``eq_transform``."""
        model, pp = self.model, statics.pairs

        @torch.no_grad()
        def node_eq_fn(pos: torch.Tensor) -> torch.Tensor:
            info = model.build_packed_pair_info(pos, statics.node_mask, pp)
            score = self.score_op(
                self.weights, statics.z, info.d_in.contiguous(), info.cmask.contiguous(),
                pp.type_r_in, pp.type_p_in, pp.type_r_out, pp.type_p_out,
                num_blocks=model.num_convs,
            )
            score = member_mean(score, self.group, self.n_members)
            return eq_transform_packed(score, pos, info.m_eq, info.d_out)

        node_eq_fn.returns_node_eq = True
        return node_eq_fn


def make_packed_ensemble_eps_fn(members: list, batch: ReactionBatch):
    """``pos -> node_eq`` (B, N, 3) of the packed ensemble on one batch
    (``PackedEnsemble``).  ``members`` are CondenseEncoderEpsNetwork modules
    on the batch's device, sharing one configuration and working dtype."""
    ensemble = PackedEnsemble(members)
    return ensemble.step_fn(ensemble.prepare(batch))


@dataclasses.dataclass(frozen=True)
class DenseStatics:
    """Per-batch inputs of the dense ensemble's step, and its counters."""

    node_mask: torch.Tensor       # (B, N) bool
    members: list                 # each member's StaticFeatures
    #: (6,) int64 on the device, real then computed: atoms (real, B N),
    #: ordered pairs of two atoms (n (n - 1) a graph, B N^2), ordered
    #: triplets k -> j -> i with k != i (n (n - 1) (n - 2), B N^3)
    counts: torch.Tensor | None = None


def pair_triplet_counts(node_mask: torch.Tensor) -> torch.Tensor:
    """``DenseStatics.counts`` of a batch's node mask (B, N), made on its
    device without reading it back."""
    n = node_mask.sum(dim=1, dtype=torch.int64)
    B, N = node_mask.shape
    grid = n.new_tensor([B * N, B * N * N, B * N ** 3])
    return torch.stack([n.sum(), grid[0], (n * (n - 1)).sum(), grid[1],
                        (n * (n - 1) * (n - 2)).sum(), grid[2]])


class DenseEnsemble:
    """The dense ensemble score, split as ``PackedEnsemble`` is: each
    member's unfused dense ``score_step`` on the step's shared pair info,
    and the mean over members."""

    def __init__(self, members: list, group=None, n_members: int | None = None):
        self.model = members[0]
        self.members = members
        self.group, self.n_members = group, n_members or len(members)

    def prepare(self, batch: ReactionBatch) -> DenseStatics:
        return DenseStatics(node_mask=batch.node_mask.clone(),
                            members=[_precompute_static(m, batch) for m in self.members],
                            counts=pair_triplet_counts(batch.node_mask))

    def step_fn(self, statics: DenseStatics):
        """``pos -> (edge_inv (B, N, N, 1), emask (B, N, N), d (B, N, N))``."""
        model, node_mask = self.model, statics.node_mask
        pairs = statics.members[0].pairs

        @torch.no_grad()
        def score(pos: torch.Tensor):
            pair_info = model.build_pair_info(pos, node_mask, pairs)
            edge_inv = member_mean(torch.stack([
                m.score_step(pos, node_mask, st, pair_info)[0]
                for m, st in zip(self.members, statics.members)
            ]), self.group, self.n_members)
            _, _, edges_out, d_out = pair_info
            return edge_inv, edges_out.mask_global, d_out

        return score


@dataclasses.dataclass(frozen=True)
class DualStatics:
    """Per-batch inputs of the dual ensemble's step: the batch's atoms, bond
    codes and node mask, and its order-extended bond graph; for a batch of
    protein subgraphs also its sidechain mask and the coordinates the
    backbone is pinned to (``pin``)."""

    node_mask: torch.Tensor   # (B, N) bool
    atom_type: torch.Tensor   # (B, N) int64
    bond_mat: torch.Tensor    # (B, N, N) int64
    mask_typed: torch.Tensor  # (B, N, N) bool
    types: torch.Tensor       # (B, N, N) int64 legacy codes
    is_sidechain: torch.Tensor | None = None  # (B, N) bool, protein mode
    pos_gt: torch.Tensor | None = None        # (B, N, 3) float32, protein mode

    def pin(self) -> dict:
        """The walk step's protein-mode arguments: ``sc3`` (B, N, 1), the
        atoms that move, and ``pos_gt``; empty for molecules."""
        if self.is_sidechain is None:
            return {}
        return {"sc3": (self.is_sidechain & self.node_mask)[..., None], "pos_gt": self.pos_gt}


class DualEnsemble:
    """The dual encoder's ensemble, split as ``PackedEnsemble`` is: the
    function of ``step_fn`` is ``eps(pos, gate, time_step, clip,
    w_global)`` -> (B, N, 3), the mean of the members' ``dual_eps``, for
    ``dual_objective.DualWalk``.  ``protein``: the batches are protein
    subgraphs, whose sidechain mask and backbone the statics keep."""

    def __init__(self, members: list, group=None, n_members: int | None = None,
                 protein: bool = False):
        self.model = members[0]
        self.members = members
        self.group, self.n_members = group, n_members or len(members)
        self.protein = protein

    @torch.no_grad()
    def prepare(self, batch: ReactionBatch) -> DualStatics:
        mask_typed, types = self.model.typed_edges(batch.bond_mat, batch.node_mask)
        protein = self.protein
        if protein and batch.is_sidechain is None:
            raise ValueError("a protein walk needs a batch that carries is_sidechain")
        return DualStatics(node_mask=batch.node_mask.clone(), atom_type=batch.atom_type.clone(),
                           bond_mat=batch.bond_mat.clone(), mask_typed=mask_typed, types=types,
                           is_sidechain=batch.is_sidechain.clone() if protein else None,
                           pos_gt=batch.pos.clone() if protein else None)

    def step_fn(self, statics: DualStatics):
        from tsdiff_tpu_torch.diffusion.dual_objective import dual_eps

        typed = (statics.mask_typed, statics.types)

        @torch.no_grad()
        def eps_fn(pos, gate, time_step, clip: float, w_global: float):
            return member_mean(torch.stack([
                dual_eps(m, statics.atom_type, statics.bond_mat, statics.node_mask, pos, gate,
                         time_step, w_global, clip, is_sidechain=statics.is_sidechain,
                         typed=typed)
                for m in self.members
            ]), self.group, self.n_members)

        return eps_fn


def make_ensemble(members: list, mesh=None) -> PackedEnsemble | DenseEnsemble | DualEnsemble:
    """The dual ensemble for dual-encoder members; else the packed ensemble
    for ``fused_score`` members (the same contract for the sampler, half the
    pair rows), else the dense one.  On a ``mesh`` with ``ens > 1``,
    ``members`` are this rank's block of the ensemble."""
    from tsdiff_tpu_torch.models.dualenc import DualEncoderEpsNetwork

    if isinstance(members[0], DualEncoderEpsNetwork):
        kind = DualEnsemble
    else:
        kind = PackedEnsemble if members[0].fused_score else DenseEnsemble
    if mesh is None or mesh.ens == 1:
        return kind(members)
    return kind(members, mesh.group("ens"), len(members) * mesh.ens)


def make_ensemble_score_fn(members: list, batch: ReactionBatch):
    """Mean-of-members score function for ``dynamic_sampling`` on one batch
    (``make_ensemble``)."""
    ensemble = make_ensemble(members)
    return ensemble.step_fn(ensemble.prepare(batch))


def load_members(paths: list[str], device, dtype, fused_score: bool = False,
                 quant: str | None = None, use_ema: bool = False, logger=None, mesh=None):
    """``(members, model_cfg)``: one model per checkpoint, rebuilt from its
    embedded config (``network``: condensenc or dualenc) with ``fused_score``
    and ``quant`` (``score_quant``) set where given, on ``device`` in eval
    mode; the config is the first member's.  A dual encoder has no fused
    score: ``fused_score`` is ignored for it with a warning, as the JAX CLI
    does.  On a ``mesh`` only this rank's block of ``paths`` over the
    ``ens`` axis is loaded."""
    if mesh is not None:
        from tsdiff_tpu_torch.parallel.sharding import shard_ensemble_params

        paths = shard_ensemble_params(list(paths), mesh)
    from tsdiff_tpu_torch.config import Config
    from tsdiff_tpu_torch.convert import params_from_jax
    from tsdiff_tpu_torch.models import get_model
    from tsdiff_tpu_torch.train import load_checkpoint, select_params

    members, model_cfg = [], None
    for path in paths:
        ck = load_checkpoint(path)
        cfg = Config(ck["config"]).model
        cfg.setdefault("network", "condensenc")
        if fused_score and cfg.network == "dualenc":
            if logger is not None and not members:
                logger.warning("--fused_score only applies to condensenc models; ignored "
                               "for DualEncoderEpsNetwork")
        elif fused_score:
            cfg.fused_score = True
        if quant not in (None, "none"):
            cfg.score_quant = quant
        if model_cfg is None:
            model_cfg = cfg
        params, used_ema = select_params(ck, use_ema)
        if use_ema and not used_ema and logger is not None:
            logger.warning("--use_ema: %s has no EMA weights; using raw params", path)
        model = get_model(cfg, dtype=dtype)
        model.load_state_dict(params_from_jax(params))
        members.append(model.to(device).eval())
    return members, model_cfg
