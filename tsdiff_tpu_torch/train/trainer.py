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

Everything a step reads or writes stays on the device, at the address it
had, so that a CUDA graph of the step replays it (``train/captured.py``), as
JAX runs its jitted step: the parameters are the model's own float32
tensors, updated in place; the optimizer state is ``{"count": 0-dim int32
tensor, "mu": {name: tensor}, "nu": {...}}``, the moments updated in place
and the bias corrections computed on the device from the count; the step
counter (``TrainState.step``, a 0-dim int32 tensor) gives the EMA's decay
on the device; the learning rate may be a 0-dim float32 tensor that its
owner refreshes in place.  ``int()`` reads the step and the count; a state
made with Python ints (a test, a resumed checkpoint) is moved to the device
by the first step.

Data parallelism (a mesh, ``parallel/sharding.py``): each rank takes the
step on its rows of the global batch, with the global batch's timesteps and
noise.  The JAX loss is the global sum over real atoms over the global
count (``tsdiff_tpu/diffusion/objective.py:118-124``), so the step first
all-reduces ``(loss_sum, n_nodes)`` over the data axes, differentiates its
own sum over the global count, and all-reduces the gradients (one flat
buffer) before the optimizer, whose global-norm clip then sees the global
gradient.  The metrics are the global ones on every rank.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from tsdiff_tpu_torch.data.resident import gather_batch
from tsdiff_tpu_torch.diffusion.objective import diffusion_loss, draw_timesteps_and_noise
from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule


def get_objective(model, schedule: DiffusionSchedule | None, t0: int = 0,
                  t1: int | None = None, anneal_power: float = 2.0):
    """``(objective, (lo, hi))``: the loss of the model's family,
    ``objective(batch, generator=None, t=None, noise=None) -> (loss, aux)``,
    and the range its levels are drawn from (``draw_timesteps_and_noise``):

    * the condensed model: the DDPM ``diffusion_loss`` over [t0, t1);
    * the dual encoder (``type: diffusion``): ``dual_diffusion_loss`` over the
      whole schedule;
    * the dual encoder (``type: dsm``): ``dual_dsm_loss`` over its sigma
      ladder, weighted by ``sigma^anneal_power``."""
    from tsdiff_tpu_torch.models.dualenc import DualEncoderEpsNetwork

    if isinstance(model, DualEncoderEpsNetwork):
        from tsdiff_tpu_torch.diffusion.dual_objective import dual_diffusion_loss, dual_dsm_loss

        if model.model_type == "diffusion":
            def objective(batch, generator=None, t=None, noise=None):
                return dual_diffusion_loss(model, schedule, batch, generator, t, noise,
                                           anneal_power)

            return objective, (0, len(schedule.alphas))

        def objective(batch, generator=None, t=None, noise=None):
            return dual_dsm_loss(model, batch, generator, t, noise, anneal_power)

        return objective, (0, model.num_noise_level)

    def objective(batch, generator=None, t=None, noise=None):
        return diffusion_loss(model, schedule, batch, t0, t1, generator, t, noise)

    return objective, (t0, len(schedule.alphas) if t1 is None else t1)


@dataclasses.dataclass
class TrainState:
    params: dict[str, torch.Tensor]   # the model's parameters (live references)
    opt_state: dict
    step: int | torch.Tensor = 0      # a 0-dim int32 device tensor once a step ran
    ema_params: dict[str, torch.Tensor] | None = None


def _counter(value, device) -> torch.Tensor:
    if isinstance(value, torch.Tensor) and value.device == device and value.dtype == torch.int32:
        return value
    return torch.tensor(int(value), dtype=torch.int32, device=device)


def on_device(state: TrainState) -> TrainState:
    """``state`` with its step and the optimizer's count as 0-dim int32
    tensors on the parameters' device, in place; a no-op once they are."""
    device = next(iter(state.params.values())).device
    state.step = _counter(state.step, device)
    state.opt_state["count"] = _counter(state.opt_state["count"], device)
    return state


class Adam:
    """Global-norm clip, Adam and decoupled weight decay, as the JAX
    package's optax chain; ``update`` returns the update before ``-lr``."""

    EPS = 1e-8  # outside the square root; eps_root is 0

    def __init__(self, b1: float, b2: float, max_grad_norm: float, weight_decay: float = 0.0):
        self.b1, self.b2 = b1, b2
        self.max_grad_norm = max_grad_norm
        self.weight_decay = weight_decay

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        device = next(iter(params.values())).device
        return {
            "count": torch.zeros((), dtype=torch.int32, device=device),
            "mu": {k: torch.zeros_like(p) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()},
        }

    @torch.no_grad()
    def update(self, grads: dict, opt_state: dict, params: dict):
        """``(updates, opt_state, grad_norm)``; ``grad_norm`` is before
        clipping.  The count (a 0-dim int32 device tensor) and the moments are
        advanced in place, and ``opt_state`` itself is returned."""
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        keep = norm < self.max_grad_norm
        count = opt_state["count"]
        count.add_(1)
        # optax computes the corrections in float32
        c = count.to(torch.float32)
        bc1 = 1 - torch.full_like(c, self.b1) ** c
        bc2 = 1 - torch.full_like(c, self.b2) ** c
        updates = {}
        for k, g in grads.items():
            g = torch.where(keep, g, g / norm * self.max_grad_norm)
            mu, nu = opt_state["mu"][k], opt_state["nu"][k]
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.EPS)
            if self.weight_decay:
                u = u + self.weight_decay * params[k]
            updates[k] = u
        return updates, opt_state, norm


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


def _data_parallel(mesh):
    """``(data group or None, blocks, this rank's block)`` of a mesh."""
    if mesh is None or mesh.dp == 1:
        return None, 1, 0
    return mesh.data_group, mesh.dp, mesh.dp_index


def _global_draws(generator, pos, t0, t1, blocks, block):
    """This rank's rows of the timesteps and noise of the global batch."""
    rows = pos.shape[0]
    t, noise = draw_timesteps_and_noise(generator, (rows * blocks, *pos.shape[1:]), t0, t1,
                                        pos.device)
    return t[block * rows:(block + 1) * rows], noise[block * rows:(block + 1) * rows]


def make_train_step(model, tx: Adam, schedule: DiffusionSchedule, t0: int = 0,
                    t1: int | None = None, ema_decay: float | None = None,
                    debug_nans: bool = False, mesh=None, anneal_power: float = 2.0):
    """``train_step(state, batch, lr, generator=None, t=None, noise=None) ->
    (state, metrics)``: one loss and gradient, the optimizer update applied
    in place to the model's parameters and the optimizer state, the step
    counter advanced and the EMA, all on the device.  ``lr`` is a float or a
    0-dim float32 device tensor.  ``t`` and ``noise`` override the draws
    from ``generator``.  The metrics stay on the device.  ``debug_nans``
    checks the loss before the backward and the gradient norm before the
    update, and raises ``FloatingPointError`` on a non-finite one (two reads
    of the card per step, so such a step cannot be captured).  On a
    ``mesh`` the batch is this rank's rows of the global batch, and ``t``
    and ``noise`` (or the generator's draws) are the global batch's
    (module docstring).  The loss is the model family's (``get_objective``)."""
    group, blocks, block = _data_parallel(mesh)
    objective, (lo, hi) = get_objective(model, schedule, t0, t1, anneal_power)

    def check(what: str, value: torch.Tensor, state: TrainState) -> None:
        if debug_nans and not bool(torch.isfinite(value)):
            raise FloatingPointError(
                f"non-finite {what} ({float(value)}) in train step {int(state.step) + 1}")

    def train_step(state: TrainState, batch, lr, generator=None, t=None, noise=None):
        state = on_device(state)
        if group is not None:
            rows = batch.pos.shape[0]
            if t is None or noise is None:
                t, noise = _global_draws(generator, batch.pos, lo, hi, blocks, block)
            else:
                t, noise = (x[block * rows:(block + 1) * rows] for x in (t, noise))
        loss, aux = objective(batch, generator, t, noise)
        if group is not None:
            totals = torch.stack([aux["loss_sum"].detach(), aux["n_nodes"]])
            dist.all_reduce(totals, group=group)
            n_nodes = totals[1]
            loss = aux["loss_sum"] / torch.clamp(n_nodes, min=1.0)
            aux = {"loss_sum": totals[0], "n_nodes": n_nodes}
        check("loss", loss.detach(), state)
        names = list(state.params)
        grads = torch.autograd.grad(loss, [state.params[k] for k in names])
        if group is not None:
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=group)
            grads = [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]
        updates, opt_state, grad_norm = tx.update(dict(zip(names, grads)), state.opt_state,
                                                  state.params)
        check("gradient norm", grad_norm, state)
        with torch.no_grad():
            neg_lr = -lr
            for k in names:
                state.params[k].add_(updates[k] * neg_lr)
            state.step.add_(1)
            ema = state.ema_params
            if ema_decay is not None and ema is not None:
                s = state.step.to(torch.float32)
                d = torch.clamp((1 + s) / (10 + s), max=ema_decay)
                keep = 1 - d
                for k in names:
                    ema[k].mul_(d).add_(state.params[k] * keep)
        if group is not None:
            loss = aux["loss_sum"] / torch.clamp(aux["n_nodes"], min=1.0)
        metrics = {"loss": loss.detach(), "loss_sum": aux["loss_sum"].detach(),
                   "n_nodes": aux["n_nodes"], "grad_norm": grad_norm}
        return TrainState(state.params, opt_state, state.step, ema), metrics

    return train_step


def _advance(cursor):
    if isinstance(cursor, torch.Tensor):
        cursor.add_(1)
        return cursor
    return cursor + 1


def make_resident_train_step(train_step, batch_size: int, mesh=None):
    """``step(state, arrays, plan, cursor, lr, **kw) -> (state, metrics,
    cursor + 1)``: ``train_step`` on batch ``cursor`` of ``plan``, gathered
    on the device from a bucket's resident arrays (``data.resident``).
    ``cursor`` is a 0-dim integer device tensor, advanced in place and
    returned, so the step reads nothing from the host, or a Python int.
    On a ``mesh`` each rank gathers its rows of the batch."""
    rows = _row_block(batch_size, mesh)

    def step(state, arrays, plan, cursor, lr, **kw):
        batch = gather_batch(arrays, plan, cursor, batch_size, rows)
        state, metrics = train_step(state, batch, lr, **kw)
        return state, metrics, _advance(cursor)

    return step


def make_resident_eval_step(eval_step, batch_size: int, mesh=None):
    """Validation twin of ``make_resident_train_step``: ``(loss_sum,
    n_nodes)`` of batch ``cursor`` of a fixed plan; a tensor ``cursor`` is
    advanced in place."""
    rows = _row_block(batch_size, mesh)

    def step(arrays, plan, cursor, **kw):
        out = eval_step(gather_batch(arrays, plan, cursor, batch_size, rows), **kw)
        _advance(cursor)
        return out

    return step


def _row_block(batch_size: int, mesh) -> slice | None:
    if mesh is None or mesh.dp == 1:
        return None
    from tsdiff_tpu_torch.parallel.sharding import batch_spec

    return batch_spec(mesh).slice(batch_size)


def make_eval_step(model, schedule: DiffusionSchedule, t0: int = 0, t1: int | None = None,
                   mesh=None, anneal_power: float = 2.0):
    """``eval_step(batch, generator=None, t=None, noise=None) -> (loss_sum,
    n_nodes)`` without gradients, so a caller can average over a whole set.
    On a ``mesh``, as ``make_train_step``: the rank's rows, the global
    draws, and the sums over the data axes."""
    group, blocks, block = _data_parallel(mesh)
    objective, (lo, hi) = get_objective(model, schedule, t0, t1, anneal_power)

    @torch.no_grad()
    def eval_step(batch, generator=None, t=None, noise=None):
        if group is not None:
            rows = batch.pos.shape[0]
            if t is None or noise is None:
                t, noise = _global_draws(generator, batch.pos, lo, hi, blocks, block)
            else:
                t, noise = (x[block * rows:(block + 1) * rows] for x in (t, noise))
        _, aux = objective(batch, generator, t, noise)
        if group is None:
            return aux["loss_sum"], aux["n_nodes"]
        totals = torch.stack([aux["loss_sum"], aux["n_nodes"]])
        dist.all_reduce(totals, group=group)
        return totals[0], totals[1]

    return eval_step
