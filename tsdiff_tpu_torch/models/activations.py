"""Activations by name, as the JAX package's registry maps them: "swish"
is x * sigmoid(x), "ssp" the shifted softplus, "leakyrelu" has slope 0.01
and "gelu" is the tanh approximation (``jax.nn.gelu``'s default).  Names are
case-insensitive ("ReLU" in the legacy configs)."""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """softplus(x) - log(2)."""
    return F.softplus(x) - math.log(2.0)


_ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "swish": F.silu,
    "silu": F.silu,
    "relu": F.relu,
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "softplus": F.softplus,
    "ssp": shifted_softplus,
}


def activation_loader(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    try:
        return _ACTIVATIONS[name.lower()]
    except KeyError as e:
        raise NotImplementedError(f"Unknown activation: {name}") from e
