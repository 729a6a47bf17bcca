"""Reverse-diffusion sampling loop.

Every update rule is AFFINE in (pos, eps_pos, noise)::

    pos_next = A_k * pos + B_k * eps_pos + C_k * noise

with coefficients that depend only on schedule scalars at step k:

  * ``ld``          annealed Langevin dynamics
  * ``ddpm``        scaled-frame DDPM
  * ``ddpm_noisy``  legacy unscaled DDPM
  * ``ddpm_det``    legacy DDPM with the posterior variance
  * ``generalized`` legacy DDIM-with-eta, clamped by the LD step sizes

(A, B, C) are computed on the host once per run (``build_step_coeffs``) and
held on the device as one (n_walk, 3) table; ``walk_step`` is one update:
score -> clip_norm -> the affine update with row k of the table -> center_pos,
where k is a device counter that the step advances.  The NaN check is a
device flag read once after the loop, so the loop never waits on the host.
Nothing of a step is fixed on the host, so a CUDA graph of ``walk_step``
replays the whole walk (``diffusion/captured.py``).  Coordinates live in the
scaled frame; ``final_frame_scale`` converts the result to the physical
frame.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from tsdiff_tpu_torch.core.geometry import center_pos, clip_norm, eq_transform
from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule

#: score_fn(pos) -> (edge_inv (B, N, N, 1), emask (B, N, N), edge_length (B, N, N))
ScoreFn = Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
#: node_eq_fn(pos) -> per-atom score vectors (B, N, 3), before clip_norm;
#: marked with the attribute ``returns_node_eq = True``
NodeEqFn = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SamplingSettings:
    sampling_type: str = "ld"   # ld | ddpm | ddpm_noisy | ddpm_det | generalized
    n_steps: int = 5000
    step_lr: float = 1e-7
    clip: float = 1000.0
    clip_pos: float | None = None
    eta: float = 1.0
    denoise_from_time_t: int | None = None
    noise_from_time_t: int | None = None
    save_traj: bool = False
    #: walk an evenly-strided m-element subsequence of the n_steps window
    #: (endpoints kept); each update pairs timestep i with the previous
    #: subsequence element j instead of i - 1.
    timestep_respacing: int | None = None


class StepCoeffs(NamedTuple):
    a: np.ndarray  # (n_steps,) coefficient of pos
    b: np.ndarray  # (n_steps,) coefficient of eps_pos
    c: np.ndarray  # (n_steps,) coefficient of noise
    timesteps: np.ndarray  # (n_steps,) the i-index walked, descending
    alphas_i: np.ndarray   # (n_steps,) alphas[i_k] for trajectory rescale


class SampleResult(NamedTuple):
    pos: torch.Tensor                 # (B, N, 3) final scaled-frame coordinates
    traj: torch.Tensor | None         # (n_steps, B, N, 3) scaled frame, execution order
    nan_detected: torch.Tensor        # () bool, on the device


def build_step_coeffs(schedule: DiffusionSchedule, settings: SamplingSettings) -> StepCoeffs:
    """Per-step affine update coefficients (float64 on the host -> float32).

    The walk is ``seq = range(t_end - n_steps, t_end)`` in reverse, each i
    paired with j = i - 1 and the last step with j = -1 (alpha = 1).  With
    ``timestep_respacing = m < n_steps`` the walk is an evenly-strided
    m-element subsequence of the same window and j the previous element.
    """
    alphas = np.asarray(schedule.alphas, dtype=np.float64)
    T = alphas.shape[0]
    sigmas = np.sqrt(1.0 - alphas) / np.sqrt(alphas)

    t_end = settings.denoise_from_time_t if settings.denoise_from_time_t is not None else T
    n = settings.n_steps
    if not (t_end >= n):
        raise ValueError(f"denoise window [{t_end - n}, {t_end}) invalid: t_end >= n_steps required")
    m = settings.timestep_respacing
    if m is not None and not (1 <= m <= n):
        raise ValueError(f"timestep_respacing={m} must be in [1, n_steps={n}]")
    if m is None or m >= n:
        i_arr = np.arange(t_end - 1, t_end - n - 1, -1)
    else:
        i_arr = np.unique(np.round(np.linspace(t_end - n, t_end - 1, m)).astype(np.int64))[::-1].copy()
    j_arr = np.concatenate([i_arr[1:], [-1]])

    at = alphas[i_arr]
    atm1 = np.where(j_arr >= 0, alphas[np.maximum(j_arr, 0)], 1.0)
    sig_i = sigmas[i_arr]
    noise_mask = (i_arr != 0).astype(np.float64)
    # schedule entries consumed by each step; the last step's gap is measured
    # to one below the window floor
    gap = (i_arr - j_arr).astype(np.float64)
    if i_arr.size:
        gap[-1] = i_arr[-1] - (t_end - n - 1)

    st = settings.sampling_type
    if st == "ld":
        step = settings.step_lr * (sig_i / 0.01) ** 2 * gap
        a = np.ones_like(at)
        b = step / sig_i
        c = np.sqrt(2.0 * step)
    elif st == "ddpm":
        beta_t = 1.0 - at / atm1
        denom = (1.0 - at) * np.sqrt(atm1)
        a = (np.sqrt(atm1) * beta_t * 1.0
             + np.sqrt(1.0 - beta_t) * (1.0 - atm1) * np.sqrt(at)) / denom
        b = np.sqrt(atm1) * beta_t * np.sqrt(1.0 / at - 1.0) / denom
        c = noise_mask * np.sqrt(beta_t) / np.sqrt(atm1)
    elif st in ("ddpm_noisy", "ddpm_det"):
        beta_t = 1.0 - at / atm1
        denom = 1.0 - at
        a = (np.sqrt(atm1) * beta_t * np.sqrt(1.0 / at)
             + np.sqrt(1.0 - beta_t) * (1.0 - atm1)) / denom
        b = np.sqrt(atm1) * beta_t * np.sqrt(1.0 / at - 1.0) / denom
        if st == "ddpm_noisy":
            c = noise_mask * np.sqrt(beta_t)
        else:
            c = noise_mask * np.sqrt(beta_t * (1.0 - atm1) / (1.0 - at))
    elif st == "generalized":
        eta = settings.eta
        c1 = eta * np.sqrt((1.0 - at / atm1) * (1.0 - atm1) / (1.0 - at))
        c2 = np.sqrt(np.maximum((1.0 - atm1) - c1**2, 0.0))
        step_pos_ld = settings.step_lr * (sig_i / 0.01) ** 2 * gap / sig_i
        step_pos_gen = 5.0 * (np.sqrt(1.0 - at) / np.sqrt(at) - c2 / np.sqrt(atm1))
        step_noise_ld = np.sqrt(settings.step_lr * (sig_i / 0.01) ** 2 * gap * 2.0)
        step_noise_gen = 3.0 * (c1 / np.sqrt(atm1))
        a = np.ones_like(at)
        b = np.minimum(step_pos_ld, step_pos_gen)
        c = np.minimum(step_noise_ld, step_noise_gen)
    else:
        raise NotImplementedError(f"Unknown sampling_type: {st}")

    f32 = lambda x: np.asarray(x, dtype=np.float32)  # noqa: E731
    return StepCoeffs(f32(a), f32(b), f32(c), i_arr.astype(np.int32), f32(at))


def initial_position(
    schedule: DiffusionSchedule,
    settings: SamplingSettings,
    pos_init: torch.Tensor,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Scaled-frame starting coordinates for the three entry modes:
    generation from pure noise (pos_init * sigmas[-1]); ``denoise_from_time_t``
    (the guess as it is); ``noise_from_time_t`` s -> t (re-noise the guess
    with sigma^2 = (1 - a_t/a_s) / a_t, with ``noise`` or a fresh draw)."""
    alphas = np.asarray(schedule.alphas, dtype=np.float64)
    if settings.noise_from_time_t is not None:
        t, s = settings.denoise_from_time_t, settings.noise_from_time_t
        if not (t is not None and t >= settings.n_steps and t >= s >= 0):
            raise ValueError("noise_from_time_t needs denoise_from_time_t >= n_steps and >= it")
        alpha_t = alphas[t - 1]
        alpha_s = alphas[s - 1] if s != 0 else 1.0
        sigma = float(np.sqrt((1.0 - alpha_t / alpha_s) / alpha_t))
        if noise is None:
            noise = torch.randn(pos_init.shape, generator=generator, device=pos_init.device)
        return pos_init + noise * sigma
    if settings.denoise_from_time_t is not None:
        if settings.denoise_from_time_t < settings.n_steps:
            raise ValueError("denoise_from_time_t must be >= n_steps")
        return pos_init
    return pos_init * float(np.sqrt(1.0 - alphas[-1]) / np.sqrt(alphas[-1]))


def step_coeff_table(coeffs: StepCoeffs, device) -> torch.Tensor:
    """(n_walk, 3) float32 rows ``[a_k, b_k, c_k]`` on ``device``."""
    return torch.from_numpy(np.stack([coeffs.a, coeffs.b, coeffs.c], axis=1)).to(device)


def at_counter(table: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    """Row ``counter`` (a 0-dim int64 device tensor) of ``table``, read on the
    device."""
    return table.index_select(0, counter.view(1))[0]


@torch.no_grad()
def walk_step(
    score_fn: ScoreFn | NodeEqFn,
    pos: torch.Tensor,          # (B, N, 3) float32
    node_mask: torch.Tensor,    # (B, N) bool
    coef: torch.Tensor,         # (n_walk, 3) float32, ``step_coeff_table``
    counter: torch.Tensor,      # () int64: the walk's position, advanced here
    step_noise: torch.Tensor,   # (B, N, 3) this step's noise
    nan_flag: torch.Tensor,     # () bool, OR-ed here
    clip: float,
    clip_pos: float | None = None,
) -> torch.Tensor:
    """One update of the reverse walk with the coefficients of row
    ``counter`` of ``coef``; returns the new positions, advances ``counter``
    and ORs a NaN check of the update into ``nan_flag``, both in place.
    Nothing here waits on or reads from the host."""
    if getattr(score_fn, "returns_node_eq", False):
        node_eq = score_fn(pos)
    else:
        edge_inv, emask, d = score_fn(pos)
        node_eq = eq_transform(edge_inv, pos, emask, d)
    eps_pos = clip_norm(node_eq, limit=clip)
    a, b, c = at_counter(coef, counter).view(3, 1, 1, 1)
    pos = a * pos + b * eps_pos + c * step_noise
    nan_flag |= torch.isnan(pos).any()
    counter += 1
    pos = center_pos(pos, node_mask)
    if clip_pos is not None:
        pos = torch.clamp(pos, -clip_pos, clip_pos)
    return pos


@torch.no_grad()
def dynamic_sampling(
    score_fn: ScoreFn | NodeEqFn,
    schedule: DiffusionSchedule,
    pos_init: torch.Tensor,    # (B, N, 3) float32
    node_mask: torch.Tensor,   # (B, N) bool
    settings: SamplingSettings,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,       # (n_steps, B, N, 3) injected step noise
    init_noise: torch.Tensor | None = None,  # (B, N, 3) for noise_from_time_t
) -> SampleResult:
    """Run the reverse-diffusion loop; returns scaled-frame coordinates.

    ``score_fn`` holds the (possibly ensembled) score network
    (``diffusion/ensemble.py``).  A dense one maps coordinates to ``(edge_inv,
    emask, edge_length)`` and is chain-ruled here with ``eq_transform``; one
    marked ``returns_node_eq`` (the packed ensemble) has already chain-ruled
    to per-atom scores.  Step noise comes from ``noise`` when given (tests
    feed another implementation's stream), else from ``generator``.
    """
    coeffs = build_step_coeffs(schedule, settings)
    n_walk = len(coeffs.a)
    if noise is not None and noise.shape != (n_walk, *pos_init.shape):
        raise ValueError(f"noise must be {(n_walk, *pos_init.shape)}, got {tuple(noise.shape)}")
    pos = initial_position(schedule, settings, pos_init, init_noise, generator)
    pos = pos * node_mask[..., None].to(pos.dtype)
    nan_flag = torch.zeros((), dtype=torch.bool, device=pos.device)
    coef = step_coeff_table(coeffs, pos.device)
    counter = torch.zeros((), dtype=torch.int64, device=pos.device)
    traj = [] if settings.save_traj else None
    for k in range(n_walk):
        step_noise = (
            noise[k] if noise is not None
            else torch.randn(pos.shape, generator=generator, device=pos.device)
        )
        pos = walk_step(score_fn, pos, node_mask, coef, counter, step_noise, nan_flag,
                        settings.clip, settings.clip_pos)
        if traj is not None:
            traj.append(pos)
    return SampleResult(
        pos=pos, traj=torch.stack(traj) if traj else None, nan_detected=nan_flag
    )


class DiffusionWalk:
    """The condensed model's reverse walk for ``WalkRunner``
    (``diffusion/captured.py``): its step table, start, update and final
    scale.  ``dual_objective.DualWalk`` is the dual encoder's, with the
    same interface."""

    def __init__(self, schedule: DiffusionSchedule, settings: SamplingSettings):
        self.schedule, self.settings = schedule, settings
        self._coeffs = build_step_coeffs(schedule, settings)
        self.n_walk = len(self._coeffs.a)
        self.scale = float(np.sqrt(self._coeffs.alphas_i[-1]))

    def start(self, pos_init, generator=None, noise=None):
        return initial_position(self.schedule, self.settings, pos_init, noise, generator)

    def tables(self, device) -> tuple[torch.Tensor]:
        return (step_coeff_table(self._coeffs, device),)

    def step(self, score_fn, pos, node_mask, tables, counter, step_noise, nan_flag):
        return walk_step(score_fn, pos, node_mask, tables[0], counter, step_noise, nan_flag,
                         self.settings.clip, self.settings.clip_pos)


def final_frame_scale(schedule: DiffusionSchedule, settings: SamplingSettings) -> float:
    """Scaled-frame -> physical-frame factor of the final positions:
    sqrt(alphas[t_end - n_steps])."""
    return float(np.sqrt(build_step_coeffs(schedule, settings).alphas_i[-1]))


def rescale_trajectory(
    traj: torch.Tensor, schedule: DiffusionSchedule, settings: SamplingSettings
) -> torch.Tensor:
    """traj[k] * sqrt(alphas[i_k]): the scaled-frame trajectory in physical coordinates."""
    scale = torch.from_numpy(np.sqrt(build_step_coeffs(schedule, settings).alphas_i))
    return traj * scale.to(traj.device)[:, None, None, None]
