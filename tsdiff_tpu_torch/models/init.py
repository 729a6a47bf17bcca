"""Parameter initialisation of the condensed model, as the JAX package's
``model.init`` draws it (not its bits: the generators differ):

* every ``nn.Linear``: weight and bias U(-1/sqrt(fan_in), +1/sqrt(fan_in)),
  torch's default and the JAX package's ``variance_scaling(1/3, "fan_in",
  "uniform")`` with its bias init;
* every ``nn.Embedding``: N(0, 1);
* the layer-stacked SchNet weights, drawn per layer: ``f1w``/``f2w``/``ow``
  and their biases as a linear layer of that fan-in, ``l1w``/``l2w`` Xavier
  uniform, ``l2b`` zero.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator | None) -> None:
    t.uniform_(-bound, bound, generator=gen)


@torch.no_grad()
def init_stack_(stack: nn.Module, gen: torch.Generator | None = None) -> None:
    """Initialise an ``InteractionStack`` in place, layer by layer."""
    for l in range(stack.f1w.shape[0]):
        for w, b in (("f1w", "f1b"), ("f2w", "f2b"), ("ow", "ob")):
            bound = 1.0 / math.sqrt(getattr(stack, w).shape[1])
            _uniform_(getattr(stack, w)[l], bound, gen)
            _uniform_(getattr(stack, b)[l], bound, gen)
        for w in ("l1w", "l2w"):
            fan_in, fan_out = getattr(stack, w).shape[1:]
            _uniform_(getattr(stack, w)[l], math.sqrt(6.0 / (fan_in + fan_out)), gen)
    stack.l2b.zero_()


@torch.no_grad()
def init_params_(model: nn.Module, gen: torch.Generator | None = None) -> None:
    """Initialise every parameter of ``model`` in place from ``gen``."""
    from tsdiff_tpu_torch.models.schnet import InteractionStack

    for module in model.modules():
        if isinstance(module, nn.Linear):
            bound = 1.0 / math.sqrt(module.in_features)
            _uniform_(module.weight, bound, gen)
            if module.bias is not None:
                _uniform_(module.bias, bound, gen)
        elif isinstance(module, nn.Embedding):
            module.weight.normal_(0.0, 1.0, generator=gen)
        elif isinstance(module, InteractionStack):
            init_stack_(module, gen)
