"""DDPM denoising objective of the condensed TS model, on padded dense
batches.

1. antithetic timesteps: half_1 ~ U[t0, t1), half_2 = t0 + t1 - 1 - half_1;
2. perturb in the scaled frame: pos + eps * sqrt(1 - abar) / sqrt(abar);
3. the network's per-pair distance scores on the perturbed geometry,
   chain-ruled to per-atom vectors with ``eq_transform``;
4. target: (d_gt - d_pert) * sqrt(abar) / sqrt(1 - abar) on the same edges,
   chain-ruled the same way;
5. per-atom squared error summed over xyz; the loss is its mean over real
   atoms.

The timesteps and the noise come from a ``torch.Generator``, or are passed
in (``t``, ``noise``), so a test can feed the JAX package's own draws and a
captured step can read them from its buffers (``draw_timesteps_and_noise``
makes the same draws before the step).  A
``fused_score`` model takes its unfused path here: the fused score kernel is
inference-only.  A ``packed_train`` model takes steps 3-4 on offset-packed
pair rows (``score_step_packed_xla``, ``eq_transform_packed``): the same
loss with half the pair rows, the k = N/2 slab's 0.5 factor riding in the
packed masks.
"""

from __future__ import annotations

import torch

from tsdiff_tpu_torch.core.geometry import eq_transform, pairwise_distance
from tsdiff_tpu_torch.core.graph import ReactionBatch
from tsdiff_tpu_torch.core.packed import eq_transform_packed, packed_distance
from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule


def sample_antithetic_timesteps(
    generator: torch.Generator | None, num_graphs: int, t0: int, t1: int, device="cpu"
) -> torch.Tensor:
    """(G,) int64 timesteps, antithetically paired."""
    sz = num_graphs // 2 + 1
    half_1 = torch.randint(t0, t1, (sz,), generator=generator, device=device)
    half_2 = t0 + t1 - 1 - half_1
    return torch.cat([half_1, half_2])[:num_graphs]


def draw_timesteps_and_noise(
    generator: torch.Generator | None, pos_shape, t0: int, t1: int, device="cpu"
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(t, noise)`` of a batch of positions ``pos_shape``, drawn from
    ``generator`` as ``diffusion_loss`` draws them: the timesteps, then the
    float32 noise."""
    t = sample_antithetic_timesteps(generator, pos_shape[0], t0, t1, device)
    return t, torch.randn(pos_shape, generator=generator, device=device)


def diffusion_loss(
    model,
    schedule: DiffusionSchedule,
    batch: ReactionBatch,
    t0: int = 0,
    t1: int | None = None,
    generator: torch.Generator | None = None,
    t: torch.Tensor | None = None,
    noise: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict]:
    """Scalar loss (mean over real atoms) and an aux dict with ``loss_sum``,
    ``n_nodes`` and ``timesteps``."""
    if t1 is None:
        t1 = len(schedule.alphas)
    pos = batch.pos
    dev = pos.device
    if t is None:
        t = sample_antithetic_timesteps(generator, pos.shape[0], t0, t1, dev)
    if noise is None:
        noise = torch.randn(pos.shape, generator=generator, device=dev, dtype=pos.dtype)
    a = schedule.alphas_on(dev)[t.to(dev)][:, None, None]  # (G, 1, 1)

    node_mask_f = batch.node_mask[..., None].to(pos.dtype)
    pos_perturbed = (pos + noise.to(dev) * torch.sqrt(1.0 - a) / torch.sqrt(a)) * node_mask_f

    if getattr(model, "packed_train", False):
        pp = model.precompute_packed_pairs(batch.bond_mat, batch.node_mask)
        z = model.node_states(batch.atom_type, batch.r_feat, batch.p_feat, batch.node_mask)
        score, info = model.score_step_packed_xla(pos_perturbed, batch.node_mask, z, pp)
        node_eq = eq_transform_packed(score, pos_perturbed, info.m_eq, info.d_out)
        d_gt = packed_distance(pos, info.m_eq > 0)
        d_target = (d_gt - info.d_out) / torch.sqrt(1.0 - a) * torch.sqrt(a)
        pos_target = eq_transform_packed(d_target, pos_perturbed, info.m_eq, info.d_out)
    else:
        # the fused score kernel has no gradient, so a sampling configuration
        # with fused_score trains through the unfused path
        unfused = {"fused": False} if getattr(model, "fused_score", False) else {}
        edge_inv, edges, d_perturbed = model(
            batch.atom_type, batch.r_feat, batch.p_feat, pos_perturbed, batch.bond_mat,
            batch.node_mask, **unfused,
        )
        emask = edges.mask_global
        node_eq = eq_transform(edge_inv, pos_perturbed, emask, d_perturbed)
        d_gt = pairwise_distance(pos, emask)
        d_target = (d_gt - d_perturbed) / torch.sqrt(1.0 - a) * torch.sqrt(a)
        pos_target = eq_transform(d_target, pos_perturbed, emask, d_perturbed)

    loss_node = torch.sum((node_eq - pos_target) ** 2, dim=-1)  # (B, N)
    mask = batch.node_mask.to(loss_node.dtype)
    loss_sum = torch.sum(loss_node * mask)
    n_nodes = torch.sum(mask)
    loss = loss_sum / torch.clamp(n_nodes, min=1.0)
    return loss, {"loss_sum": loss_sum, "n_nodes": n_nodes, "timesteps": t}
