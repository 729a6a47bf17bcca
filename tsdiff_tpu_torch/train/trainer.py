"""Training: the optimizer, the update step and the validation step.

The optimizer keeps optax's semantics exactly, as the JAX package chains
them (``clip_by_global_norm`` -> ``scale_by_adam`` -> optional
``add_decayed_weights``, then ``-lr * u``):

* clip: scale by ``max_norm / norm`` only when ``norm >= max_norm``
  (``g / norm * max_norm``); ``torch.nn.utils.clip_grad_norm_`` divides by
  ``norm + 1e-6`` instead;
* Adam: ``eps = 1e-8`` outside the square root, ``eps_root = 0``, bias
  correction by ``1 - b^count``;
* weight decay is added to the Adam update (decoupled, as AdamW), not to the
  gradient;
* EMA of the parameters with the warmed decay ``min(decay, (1 + step) /
  (10 + step))``.

The parameters are the model's own float32 tensors, updated in place; the
optimizer state is ``{"count": int, "mu": {name: tensor}, "nu": {...}}``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tsdiff_tpu_torch.data.resident import gather_batch
from tsdiff_tpu_torch.diffusion.objective import diffusion_loss
from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule


@dataclasses.dataclass
class TrainState:
    params: dict[str, torch.Tensor]   # the model's parameters (live references)
    opt_state: dict
    step: int = 0
    ema_params: dict[str, torch.Tensor] | None = None


class Adam:
    """Global-norm clip, Adam and decoupled weight decay, as the JAX
    package's optax chain; ``update`` returns the update before ``-lr``."""

    EPS = 1e-8  # outside the square root; eps_root is 0

    def __init__(self, b1: float, b2: float, max_grad_norm: float, weight_decay: float = 0.0):
        self.b1, self.b2 = b1, b2
        self.max_grad_norm = max_grad_norm
        self.weight_decay = weight_decay

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        return {
            "count": 0,
            "mu": {k: torch.zeros_like(p) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()},
        }

    @torch.no_grad()
    def update(self, grads: dict, opt_state: dict, params: dict):
        """``(updates, opt_state, grad_norm)``; ``grad_norm`` is before clipping."""
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        keep = norm < self.max_grad_norm
        count = opt_state["count"] + 1
        # optax computes the corrections in float32
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(count))
        mu, nu, updates = {}, {}, {}
        for k, g in grads.items():
            g = torch.where(keep, g, g / norm * self.max_grad_norm)
            mu[k] = (1 - self.b1) * g + self.b1 * opt_state["mu"][k]
            nu[k] = (1 - self.b2) * (g * g) + self.b2 * opt_state["nu"][k]
            u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.EPS)
            if self.weight_decay:
                u = u + self.weight_decay * params[k]
            updates[k] = u
        return updates, {"count": count, "mu": mu, "nu": nu}, norm


def make_optimizer(opt_config, max_grad_norm: float) -> Adam:
    if opt_config.type != "adam":
        raise NotImplementedError(f"Optimizer not supported: {opt_config.type}")
    return Adam(opt_config.beta1, opt_config.beta2, max_grad_norm,
                weight_decay=opt_config.get("weight_decay", 0.0))


def init_train_state(model: torch.nn.Module, tx: Adam,
                     ema_decay: float | None = None) -> TrainState:
    params = dict(model.named_parameters())
    ema = {k: p.detach().clone() for k, p in params.items()} if ema_decay else None
    return TrainState(params=params, opt_state=tx.init(params), step=0, ema_params=ema)


def make_train_step(model, tx: Adam, schedule: DiffusionSchedule, t0: int = 0,
                    t1: int | None = None, ema_decay: float | None = None,
                    debug_nans: bool = False):
    """``train_step(state, batch, lr, generator=None, t=None, noise=None) ->
    (state, metrics)``: one loss and gradient, the optimizer update applied
    to the model's parameters in place, and the EMA.  ``t`` and ``noise``
    override the draws from ``generator``.  The metrics stay on the device.
    ``debug_nans`` checks the loss before the backward and the gradient norm
    before the update, and raises ``FloatingPointError`` on a non-finite one
    (two reads of the card per step)."""

    def check(what: str, value: torch.Tensor, step: int) -> None:
        if debug_nans and not bool(torch.isfinite(value)):
            raise FloatingPointError(f"non-finite {what} ({float(value)}) in train step {step}")

    def train_step(state: TrainState, batch, lr: float, generator=None, t=None, noise=None):
        loss, aux = diffusion_loss(model, schedule, batch, t0, t1, generator, t, noise)
        check("loss", loss.detach(), state.step + 1)
        names = list(state.params)
        grads = torch.autograd.grad(loss, [state.params[k] for k in names])
        updates, opt_state, grad_norm = tx.update(dict(zip(names, grads)), state.opt_state,
                                                  state.params)
        check("gradient norm", grad_norm, state.step + 1)
        step = state.step + 1
        with torch.no_grad():
            for k in names:
                state.params[k].add_(updates[k] * -lr)
            ema = state.ema_params
            if ema_decay is not None and ema is not None:
                d = min(np.float32(ema_decay), np.float32(1 + step) / np.float32(10 + step))
                for k in names:
                    ema[k].mul_(float(d)).add_(state.params[k] * float(np.float32(1) - d))
        metrics = {"loss": loss.detach(), "loss_sum": aux["loss_sum"].detach(),
                   "n_nodes": aux["n_nodes"], "grad_norm": grad_norm}
        return TrainState(state.params, opt_state, step, ema), metrics

    return train_step


def make_resident_train_step(train_step, batch_size: int):
    """``step(state, arrays, plan, cursor, lr, **kw) -> (state, metrics,
    cursor + 1)``: ``train_step`` on batch ``cursor`` of ``plan``, gathered
    on the device from a bucket's resident arrays (``data.resident``).
    ``cursor`` is a Python integer: the step reads nothing back from the card."""

    def step(state, arrays, plan, cursor: int, lr: float, **kw):
        state, metrics = train_step(state, gather_batch(arrays, plan, cursor, batch_size), lr, **kw)
        return state, metrics, cursor + 1

    return step


def make_resident_eval_step(eval_step, batch_size: int):
    """Validation twin of ``make_resident_train_step``: ``(loss_sum,
    n_nodes)`` of batch ``cursor`` of a fixed plan."""

    def step(arrays, plan, cursor: int, **kw):
        return eval_step(gather_batch(arrays, plan, cursor, batch_size), **kw)

    return step


def make_eval_step(model, schedule: DiffusionSchedule, t0: int = 0, t1: int | None = None):
    """``eval_step(batch, generator=None, t=None, noise=None) -> (loss_sum,
    n_nodes)`` without gradients, so a caller can average over a whole set."""

    @torch.no_grad()
    def eval_step(batch, generator=None, t=None, noise=None):
        _, aux = diffusion_loss(model, schedule, batch, t0, t1, generator, t, noise)
        return aux["loss_sum"], aux["n_nodes"]

    return eval_step
