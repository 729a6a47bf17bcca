"""The reverse walk of TSDiff and GeoDiff in plain numpy and torch: the
noise schedule, the respaced Langevin (``ld``) coefficients, the start and
one update.

* betas: ``sigmoid`` from ``beta_start`` to ``beta_end`` over T steps in
  float64, then float32; ``alpha_bar_t = alpha_bar_{t-1} (1 - beta_t)`` in
  float32, one product after the other (a parallel scan's order moves
  ``1 - alpha_bar`` near t = 0, and so the late steps' sigmas, by up to
  6e-4);
* ``sigma_t = sqrt(1 - alpha_bar_t) / sqrt(alpha_bar_t)``; the walk starts
  at ``sigma_{T-1}`` times unit noise, masked;
* respacing to M steps walks ``unique(round(linspace(0, T - 1, M)))``
  downwards; a step at timestep i consumes the ``gap`` schedule entries down
  to the next timestep walked (down to -1 for the last);
* ``ld``: ``step = step_lr * (sigma_i / 0.01) ** 2 * gap``, and
  ``pos' = center(pos + step / sigma_i * eps + sqrt(2 step) * noise)``;
* the physical frame of the last positions: times ``sqrt(alpha_bar_{i_last})``,
  the root taken in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import graphs as G


def alpha_bars(config: dict) -> np.ndarray:
    T = config["num_diffusion_timesteps"]
    if config["beta_schedule"] != "sigmoid":
        raise ValueError(f"only the sigmoid schedule is referenced, got {config['beta_schedule']}")
    x = np.linspace(-6, 6, T)
    betas = (1.0 / (np.exp(-x) + 1.0)) * (config["beta_end"] - config["beta_start"]) \
        + config["beta_start"]
    one_minus = np.float32(1.0) - betas.astype(np.float32)
    out = np.empty(T, np.float32)
    acc = np.float32(1.0)
    for t in range(T):
        acc = np.float32(acc * one_minus[t])
        out[t] = acc
    return out


class LangevinWalk:
    """The respaced ``ld`` walk of a configuration's schedule."""

    def __init__(self, config: dict, n_steps: int, respacing: int, step_lr: float):
        al32 = alpha_bars(config)
        al = al32.astype(np.float64)
        T = len(al)
        if n_steps != T:
            raise ValueError("the reference walks the whole schedule")
        i = np.unique(np.round(np.linspace(0, T - 1, respacing)).astype(np.int64))[::-1]
        gap = np.concatenate([i[:-1] - i[1:], [i[-1] + 1]]).astype(np.float64)
        sigma = np.sqrt(1.0 - al) / np.sqrt(al)
        step = step_lr * (sigma[i] / 0.01) ** 2 * gap
        self.b = step / sigma[i]
        self.c = np.sqrt(2.0 * step)
        self.sigma_start = float(sigma[-1])
        self.scale = float(np.sqrt(al32[i[-1]]))     # a float32 square root, as published
        self.n_walk = len(i)

    def start(self, pos_init: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
        return pos_init * self.sigma_start * node_mask[..., None].float()

    def update(self, k: int, pos, eps, noise, node_mask, clip: float | None):
        """Step ``k`` from ``pos`` with the score ``eps``: ``(next, the
        score's part b * eps, centred)``."""
        if clip is not None:
            eps = G.clip_norm(eps, clip)
        nxt = G.center(pos + self.b[k] * eps + self.c[k] * noise, node_mask)
        return nxt, G.center(self.b[k] * eps, node_mask)
