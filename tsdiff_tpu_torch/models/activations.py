"""Activations: "swish" is x * sigmoid(x); "ssp" the shifted softplus."""

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
    "ssp": shifted_softplus,
}


def activation_loader(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    try:
        return _ACTIVATIONS[name.lower()]
    except KeyError as e:
        raise NotImplementedError(f"Unknown activation: {name}") from e
