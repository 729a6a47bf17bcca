"""Diffusion noise schedules, computed in float64 numpy on the host.

Betas are float64 and cast to float32; ``alphas = cumprod(1 - betas)`` runs
in float32.  The trained configuration: sigmoid schedule, beta in
[1e-7, 2e-3], T = 5000.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def get_beta_schedule(
    beta_schedule: str, *, beta_start: float, beta_end: float, num_diffusion_timesteps: int
) -> np.ndarray:
    """Beta schedule as float64 numpy, (T,)."""

    def sigmoid(x):
        return 1.0 / (np.exp(-x) + 1.0)

    T = num_diffusion_timesteps
    if beta_schedule == "quad":
        betas = np.linspace(beta_start**0.5, beta_end**0.5, T, dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, T, dtype=np.float64)
    elif beta_schedule == "const":
        betas = beta_end * np.ones(T, dtype=np.float64)
    elif beta_schedule == "jsd":  # 1/T, 1/(T-1), ..., 1
        betas = 1.0 / np.linspace(T, 1, T, dtype=np.float64)
    elif beta_schedule == "sigmoid":
        betas = sigmoid(np.linspace(-6, 6, T)) * (beta_end - beta_start) + beta_start
    else:
        raise NotImplementedError(beta_schedule)
    assert betas.shape == (T,)
    return betas


def alphas_from_betas(betas: np.ndarray) -> np.ndarray:
    """alpha_bar_t = prod_{s<=t} (1 - beta_s), in float32."""
    one_minus = np.float32(1.0) - betas.astype(np.float32)
    return np.cumprod(one_minus, dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    betas: np.ndarray   # (T,) float32
    alphas: np.ndarray  # (T,) float32 cumulative products
    _alphas_on: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def alphas_on(self, device):
        """``alphas`` as a torch tensor on ``device``, copied there once."""
        import torch

        device = torch.device(device)
        if device not in self._alphas_on:
            self._alphas_on[device] = torch.as_tensor(self.alphas, device=device)
        return self._alphas_on[device]

    @property
    def sigmas(self) -> np.ndarray:
        """sigma_t = sqrt(1 - abar_t) / sqrt(abar_t): the scaled-frame noise ladder."""
        return np.sqrt(1.0 - self.alphas) / np.sqrt(self.alphas)

    @classmethod
    def from_config(cls, config) -> "DiffusionSchedule":
        betas = get_beta_schedule(
            config.beta_schedule,
            beta_start=config.beta_start,
            beta_end=config.beta_end,
            num_diffusion_timesteps=config.num_diffusion_timesteps,
        ).astype(np.float32)
        return cls(betas=betas, alphas=alphas_from_betas(betas))
