"""Losses and reverse walks of the GeoDiff-legacy dual-encoder model.

* ``dual_diffusion_loss``: DDPM denoising on both branches, mixed
  ``(2 * global + 5 * local) / 7``; the global branch is scored on the
  non-local edges within the cutoff, the local branch on the typed edges;
* ``dual_dsm_loss``: annealed score matching over the model's sigma ladder,
  ``2 * 0.5 * global * sigma^p + 5 * 0.5 * local * sigma^p``;
* ``make_dual_eps_fn``: the sampler's per-atom score, the local branch plus
  the gated, down-weighted (``w_global``), clipped global branch;
* ``dual_dynamic_sampling``: the DDPM-family walk with the update rules and
  coefficients of ``diffusion/sampler.py``;
* ``dsm_annealed_sampling``: annealed Langevin over the sigma ladder,
  ``n_steps`` per level, optionally over an evenly strided subsequence of
  the levels (``sigma_respacing``, ``respaced_sigma_levels``).

Random draws come from a ``torch.Generator`` or are passed in (``t``,
``noise``), so a test feeds another implementation's draws, and a captured
step reads them from its buffers.  A walk is a table of per-step rows
``[a, b, c, gate]`` and levels read at a device counter (``DualWalk``), one
``dual_walk_step`` per step, so a CUDA graph of the step replays the whole
walk (``diffusion/captured.py``), as for the condensed model.  Protein mode
(``is_sidechain``, ``pos_gt``) pins the backbone atoms to ``pos_gt`` after
every step and does not recentre.
"""

from __future__ import annotations

import numpy as np
import torch

from tsdiff_tpu_torch.core.geometry import center_pos, clip_norm, eq_transform, pairwise_distance
from tsdiff_tpu_torch.core.graph import ReactionBatch
from tsdiff_tpu_torch.diffusion.objective import sample_antithetic_timesteps
from tsdiff_tpu_torch.diffusion.sampler import (
    SampleResult,
    SamplingSettings,
    at_counter,
    build_step_coeffs,
    initial_position,
)
from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(x)


def _branch_losses(edge_inv_global, edge_inv_local, edges, d_perturbed, pos_perturbed,
                   d_target, cutoff, d_cutoff=None):
    """Per-atom squared errors ``(loss_global, loss_local)`` (B, N) of the
    two branches.  The global branch is scored on the global edges that are
    not local and lie within ``cutoff`` (tested on ``d_cutoff``, by default
    the perturbed distances); the local branch on the typed edges.  Every
    chain rule uses the perturbed distances."""
    eg = edge_inv_global[..., 0] if edge_inv_global.dim() == 4 else edge_inv_global
    el = edge_inv_local[..., 0] if edge_inv_local.dim() == 4 else edge_inv_local
    if d_cutoff is None:
        d_cutoff = d_perturbed
    local, glob = edges.mask_local, edges.mask_global
    global_mask = ((d_cutoff <= cutoff) | local) & ~local & glob
    target_d_global = torch.where(global_mask, d_target, _zero(d_target))
    eg = torch.where(global_mask, eg, _zero(eg))
    target_pos_global = eq_transform(target_d_global, pos_perturbed, glob, d_perturbed)
    node_eq_global = eq_transform(eg, pos_perturbed, glob, d_perturbed)
    loss_global = torch.sum((node_eq_global - target_pos_global) ** 2, dim=-1)

    d_local = torch.where(local, d_perturbed, torch.ones_like(d_perturbed))
    target_pos_local = eq_transform(torch.where(local, d_target, _zero(d_target)),
                                    pos_perturbed, local, d_local)
    node_eq_local = eq_transform(torch.where(local, el, _zero(el)), pos_perturbed, local, d_local)
    loss_local = torch.sum((node_eq_local - target_pos_local) ** 2, dim=-1)
    return loss_global, loss_local


def _draws(generator, pos, t, noise, levels: int):
    """The antithetic levels over [0, levels) and the noise, drawn in that
    order where not given."""
    dev = pos.device
    if t is None:
        t = sample_antithetic_timesteps(generator, pos.shape[0], 0, levels, dev)
    if noise is None:
        noise = torch.randn(pos.shape, generator=generator, device=dev, dtype=pos.dtype)
    return t.to(dev), noise.to(dev)


def _mean_over_atoms(loss_node, node_mask, **extra):
    mask = node_mask.to(loss_node.dtype)
    n_nodes = mask.sum()
    loss_sum = torch.sum(loss_node * mask)
    n = torch.clamp(n_nodes, min=1.0)
    aux = {"loss_sum": loss_sum, "n_nodes": n_nodes}
    aux.update({k: torch.sum(v * mask) / n for k, v in extra.items()})
    return loss_sum / n, aux


def dual_diffusion_loss(model, schedule: DiffusionSchedule, batch: ReactionBatch,
                        generator: torch.Generator | None = None, t=None, noise=None,
                        anneal_power: float = 2.0, is_sidechain=None):
    """DDPM loss of the dual encoder: timesteps antithetic over the whole
    schedule, positions perturbed in the scaled frame, the distance target
    ``(d_gt - d_pert) / sqrt(1 - a) * sqrt(a)``.  ``(loss, aux)``, aux with
    ``loss_sum``, ``n_nodes``, ``loss_global``, ``loss_local``.
    ``anneal_power`` is unused (the DSM loss's)."""
    t, noise = _draws(generator, batch.pos, t, noise, len(schedule.alphas))
    a = schedule.alphas_on(batch.pos.device)[t][:, None, None]
    node_mask_f = batch.node_mask[..., None].to(batch.pos.dtype)
    pos_perturbed = (batch.pos + noise * torch.sqrt(1 - a) / torch.sqrt(a)) * node_mask_f

    eg, el, edges, d_pert = model(batch.atom_type, pos_perturbed, batch.bond_mat,
                                  batch.node_mask, is_sidechain=is_sidechain)
    d_gt = pairwise_distance(batch.pos, edges.mask_global)
    d_target = (d_gt - d_pert) / torch.sqrt(1 - a) * torch.sqrt(a)
    lg, ll = _branch_losses(eg, el, edges, d_pert, pos_perturbed, d_target, model.cutoff)
    aa, bb = 2.0, 5.0
    loss_node = (aa * lg + bb * ll) / (aa + bb)
    return _mean_over_atoms(loss_node, batch.node_mask, loss_global=lg, loss_local=ll)


def is_train_edge_mask(edges_mask: torch.Tensor, is_sidechain: torch.Tensor) -> torch.Tensor:
    """(B, N, N) edges that carry a training signal: an end is a sidechain
    atom."""
    sc = is_sidechain.to(torch.bool)
    return edges_mask & (sc[:, :, None] | sc[:, None, :])


def dual_dsm_loss(model, batch: ReactionBatch, generator: torch.Generator | None = None,
                  t=None, noise=None, anneal_power: float = 2.0, is_sidechain=None):
    """Annealed score-matching loss: levels antithetic over the ladder,
    ``pos + noise * sigma``, the target ``(d_gt - d_pert) / sigma^2``, each
    atom's error weighted by ``sigma^anneal_power``.  Protein mode
    (``is_sidechain``): backbone-backbone edges take the true distance in
    the target and the cutoff test, zeroing their target.  ``(loss, aux)``
    with ``loss_sum`` and ``n_nodes``."""
    sigmas = model.sigma_table
    t, noise = _draws(generator, batch.pos, t, noise, sigmas.shape[0])
    s_pos = sigmas[t][:, None, None]
    node_mask_f = batch.node_mask[..., None].to(batch.pos.dtype)
    pos_perturbed = (batch.pos + noise * s_pos) * node_mask_f

    eg, el, edges, d_pert = model(batch.atom_type, pos_perturbed, batch.bond_mat,
                                  batch.node_mask, time_step=t, is_sidechain=is_sidechain)
    d_gt = pairwise_distance(batch.pos, edges.mask_global)
    d_replaced = d_pert
    if is_sidechain is not None:
        train_mask = is_train_edge_mask(edges.mask_global, is_sidechain)
        d_replaced = torch.where(train_mask, d_pert, d_gt)
    d_target = (d_gt - d_replaced) / s_pos**2
    lg, ll = _branch_losses(eg, el, edges, d_pert, pos_perturbed, d_target, model.cutoff,
                            d_cutoff=d_replaced)
    w = s_pos[..., 0] ** anneal_power
    loss_node = 2.0 * 0.5 * lg * w + 5.0 * 0.5 * ll * w
    return _mean_over_atoms(loss_node, batch.node_mask)


def dual_eps(model, atom_type, bond_mat, node_mask, pos, sigma_gate, time_step=None,
             w_global: float = 0.2, clip: float = 1000.0, clip_local: float | None = None,
             is_sidechain=None, typed=None) -> torch.Tensor:
    """One model's per-atom score (B, N, 3): the local branch chain-ruled on
    the typed edges (clipped to ``clip_local`` where given) plus ``sigma_gate
    * w_global`` times the global branch chain-ruled on the non-local edges,
    clipped to ``clip``.  ``typed``: ``model.typed_edges`` made once."""
    eg, el, edges, d = model(atom_type, pos, bond_mat, node_mask, time_step=time_step,
                             is_sidechain=is_sidechain, typed=typed)
    local = edges.mask_local
    d_local = torch.where(local, d, torch.ones_like(d))
    el = el[..., 0]
    node_eq_local = eq_transform(torch.where(local, el, _zero(el)), pos, local, d_local)
    if clip_local is not None:
        node_eq_local = clip_norm(node_eq_local, clip_local)
    eg = eg[..., 0]
    node_eq_global = eq_transform(torch.where(local, _zero(eg), eg), pos, edges.mask_global, d)
    node_eq_global = clip_norm(node_eq_global, clip)
    return node_eq_local + sigma_gate * w_global * node_eq_global


def make_dual_eps_fn(model, batch: ReactionBatch, w_global: float = 0.2,
                     global_start_sigma: float = float("inf"), clip: float = 1000.0,
                     clip_local: float | None = None, schedule=None, is_sidechain=None):
    """``eps_fn(pos, sigma_gate, time_step=None)`` of one model on one batch
    (``dual_eps``); ``sigma_gate`` is the step's 0/1 gate ``sigma <
    global_start_sigma``, made by the walk."""

    @torch.no_grad()
    def eps_fn(pos, sigma_gate, time_step=None):
        return dual_eps(model, batch.atom_type, batch.bond_mat, batch.node_mask, pos,
                        sigma_gate, time_step, w_global, clip, clip_local, is_sidechain)

    return eps_fn


def respaced_sigma_levels(lvl: np.ndarray, m: int | None) -> np.ndarray:
    """An evenly strided ``m``-element subsequence of the kept ladder levels
    ``lvl``, both ends kept (for ``m = 1`` the last, so that the anneal ends
    at sigma_end); ``None`` or ``len(lvl)`` keeps all.  The values are the
    original ladder indices, on which the model is conditioned."""
    lvl = np.asarray(lvl)
    if m is None or m == len(lvl):
        return lvl
    if not (1 <= m <= len(lvl)):
        raise ValueError(f"sigma_respacing={m} must be in [1, {len(lvl)} kept levels]")
    idx = np.round(np.linspace(0, len(lvl) - 1, m)).astype(int)
    idx[-1] = len(lvl) - 1
    return lvl[np.unique(idx)]


class DualWalk:
    """The reverse walk of the dual encoder as per-step tables: rows ``[a,
    b, c, gate]`` (float32) and the level each step conditions on (int64),
    read at a device counter by ``dual_walk_step``.  ``diffusion`` builds it
    from the DDPM coefficients of ``build_step_coeffs``, ``dsm`` from the
    sigma ladder.  ``start`` makes the walk's first positions; ``scale``
    takes the last ones to the physical frame.  ``clip`` is the global
    branch's clip, ``w_global`` its weight."""

    def __init__(self, coef: np.ndarray, levels: np.ndarray, start, scale: float,
                 clip: float, clip_pos: float | None, w_global: float = 0.2):
        self.coef = np.asarray(coef, np.float32)
        self.levels = np.asarray(levels, np.int64)
        self.n_walk = len(self.levels)
        self._start = start
        self.scale = scale
        self.clip, self.clip_pos, self.w_global = clip, clip_pos, w_global

    @classmethod
    def diffusion(cls, schedule: DiffusionSchedule, settings: SamplingSettings,
                  global_start_sigma: float = float("inf"), w_global: float = 0.2):
        coeffs = build_step_coeffs(schedule, settings)
        alphas = np.asarray(schedule.alphas, np.float64)
        sigmas = np.sqrt(1.0 - alphas) / np.sqrt(alphas)
        gates = (sigmas[coeffs.timesteps] < global_start_sigma).astype(np.float32)
        coef = np.stack([coeffs.a, coeffs.b, coeffs.c, gates], axis=1)

        def start(pos_init, generator=None, noise=None):
            return initial_position(schedule, settings, pos_init, noise, generator)

        return cls(coef, coeffs.timesteps, start, float(np.sqrt(coeffs.alphas_i[-1])),
                   settings.clip, settings.clip_pos, w_global)

    @classmethod
    def dsm(cls, sigmas: np.ndarray, n_steps: int = 100, step_lr: float = 1e-6,
            min_sigma: float = 0.0, clip: float = 1000.0, clip_pos: float | None = None,
            global_start_sigma: float = float("inf"), sigma_respacing: int | None = None,
            w_global: float = 0.2):
        sigmas = np.asarray(sigmas, dtype=np.float64)
        lvl = respaced_sigma_levels(np.where(sigmas >= min_sigma)[0], sigma_respacing)
        step_flat = np.repeat(step_lr * (sigmas[lvl] / sigmas[-1]) ** 2, n_steps)
        level_flat = np.repeat(lvl, n_steps)
        gates = (sigmas[level_flat] < global_start_sigma).astype(np.float32)
        b = step_flat.astype(np.float32)
        c = np.sqrt(step_flat * 2.0).astype(np.float32)
        coef = np.stack([np.ones_like(b), b, c, gates], axis=1)
        return cls(coef, level_flat, lambda pos_init, generator=None, noise=None: pos_init,
                   1.0, clip, clip_pos, w_global)

    def start(self, pos_init, generator=None, noise=None):
        """The walk's first positions from the unit-variance ``pos_init``
        (re-noised first for ``noise_from_time_t``, with ``noise`` or a draw
        from ``generator``); not yet masked."""
        return self._start(pos_init, generator, noise)

    def tables(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """``(coef (n_walk, 4) float32, levels (n_walk,) int64)`` on ``device``."""
        return (torch.from_numpy(self.coef).to(device),
                torch.from_numpy(self.levels).to(device))

    def step(self, eps_fn, pos, node_mask, tables, counter, step_noise, nan_flag,
             sc3=None, pos_gt=None):
        """One ``dual_walk_step`` of this walk; ``eps_fn(pos, gate,
        time_step, clip, w_global)``."""
        coef, levels = tables
        return dual_walk_step(
            lambda p, g, t: eps_fn(p, g, t, self.clip, self.w_global), pos, node_mask,
            coef, levels, counter, step_noise, nan_flag, self.clip_pos, sc3, pos_gt)


@torch.no_grad()
def dual_walk_step(eps_fn, pos, node_mask, coef, levels, counter, step_noise, nan_flag,
                   clip_pos: float | None = None, sc3=None, pos_gt=None) -> torch.Tensor:
    """One update ``a * pos + b * eps + c * noise`` with row ``counter`` of
    ``coef`` ``[a, b, c, gate]``, ``eps = eps_fn(pos, gate, level)`` at the
    row's level for every graph; backbone atoms pinned to ``pos_gt`` where
    ``sc3`` (B, N, 1) is False, else the result recentred; clamped to
    ``clip_pos``.  Advances ``counter`` and ORs a NaN check into
    ``nan_flag``, in place; reads nothing from the host."""
    a, b, c, gate = at_counter(coef, counter).unbind(0)
    time_step = at_counter(levels, counter).expand(pos.shape[0])
    eps_pos = eps_fn(pos, gate, time_step)
    pos_next = a * pos + b * eps_pos + c * step_noise
    if sc3 is not None:
        pos_next = torch.where(sc3, pos_next, pos_gt)
    nan_flag |= torch.isnan(pos_next).any()
    counter += 1
    if sc3 is None:
        pos_next = center_pos(pos_next, node_mask)
    if clip_pos is not None:
        pos_next = torch.clamp(pos_next, -clip_pos, clip_pos)
    return pos_next


def _run_walk(walk: DualWalk, eps_fn, pos_init, node_mask, generator, noise, init_noise,
              save_traj: bool, is_sidechain=None, pos_gt=None) -> SampleResult:
    if is_sidechain is not None and pos_gt is None:
        raise ValueError("need crd of backbone for sidechain prediction")
    n_walk = walk.n_walk
    if noise is not None and noise.shape != (n_walk, *pos_init.shape):
        raise ValueError(f"noise must be {(n_walk, *pos_init.shape)}, got {tuple(noise.shape)}")
    pos = walk.start(pos_init, generator, init_noise) * node_mask[..., None].to(pos_init.dtype)
    sc3 = None
    if is_sidechain is not None:
        sc3 = (is_sidechain & node_mask)[..., None]
        pos = torch.where(sc3, pos, pos_gt)
    dev = pos.device
    tables = walk.tables(dev)
    counter = torch.zeros((), dtype=torch.int64, device=dev)
    nan_flag = torch.zeros((), dtype=torch.bool, device=dev)
    traj = [] if save_traj else None
    step_fn = lambda p, g, t, clip, w: eps_fn(p, g, time_step=t)  # noqa: E731
    for k in range(n_walk):
        step_noise = (noise[k] if noise is not None
                      else torch.randn(pos.shape, generator=generator, device=dev))
        pos = walk.step(step_fn, pos, node_mask, tables, counter, step_noise, nan_flag,
                        sc3, pos_gt)
        if traj is not None:
            traj.append(pos)
    return SampleResult(pos=pos, traj=torch.stack(traj) if traj else None, nan_detected=nan_flag)


def dual_dynamic_sampling(eps_fn, schedule: DiffusionSchedule, pos_init, node_mask,
                          settings: SamplingSettings, generator=None, noise=None,
                          init_noise=None, global_start_sigma: float = float("inf"),
                          is_sidechain=None, pos_gt=None) -> SampleResult:
    """The DDPM-family walk of ``settings`` (every ``sampling_type``, the
    three entry modes and ``timestep_respacing``, as ``dynamic_sampling``)
    on ``eps_fn(pos, gate, time_step=)`` (``make_dual_eps_fn``, which holds
    the clip).  Step noise from ``noise`` (n_walk, B, N, 3) when given, else
    one draw of (B, N, 3) per step from ``generator``; scaled-frame
    result."""
    walk = DualWalk.diffusion(schedule, settings, global_start_sigma)
    return _run_walk(walk, eps_fn, pos_init, node_mask, generator, noise, init_noise,
                     settings.save_traj, is_sidechain, pos_gt)


def dsm_annealed_sampling(eps_fn, sigmas: np.ndarray, pos_init, node_mask, n_steps: int = 100,
                          step_lr: float = 1e-6, min_sigma: float = 0.0,
                          clip_pos: float | None = None, save_traj: bool = False,
                          global_start_sigma: float = float("inf"), is_sidechain=None,
                          pos_gt=None, sigma_respacing: int | None = None,
                          generator=None, noise=None) -> SampleResult:
    """Annealed Langevin over the ladder levels with sigma >= ``min_sigma``
    (or ``sigma_respacing`` of them): ``n_steps`` steps per level of
    ``pos += step * eps + sqrt(2 * step) * noise``, ``step = step_lr *
    (sigma / sigma_end)^2``, the model conditioned on the level's original
    index.  Starts from ``pos_init`` as it is."""
    walk = DualWalk.dsm(sigmas, n_steps, step_lr, min_sigma, clip_pos=clip_pos,
                        global_start_sigma=global_start_sigma, sigma_respacing=sigma_respacing)
    return _run_walk(walk, eps_fn, pos_init, node_mask, generator, noise, None, save_traj,
                     is_sidechain, pos_gt)
