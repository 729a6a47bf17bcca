"""Multi-layer perceptron as an ``nn.Linear`` stack: activation between all
but the last layer.  Layers are named ``layers.<i>``, as the checkpoint's
``layers_<i>`` map to them (``tsdiff_tpu_torch.convert``).

Parameters stay float32; ``linear`` casts them to the input's type at each
use, as a flax ``Dense(dtype=...)`` does, so a bf16 forward trains float32
master weights."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tsdiff_tpu_torch.models.activations import activation_loader


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)`` computed in x's type from the float32 parameters."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


class MLP(nn.Module):
    def __init__(self, in_dim: int, hidden_dims: Sequence[int], activation: str = "relu"):
        super().__init__()
        dims = [in_dim, *hidden_dims]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.act = activation_loader(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = linear(layer, x)
            if i < len(self.layers) - 1:
                x = self.act(x)
        return x
