"""Multi-layer perceptron as an ``nn.Linear`` stack: activation between all
but the last layer.  Layers are named ``layers.<i>``, as the checkpoint's
``layers_<i>`` map to them (``tsdiff_tpu_torch.convert``)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tsdiff_tpu_torch.models.activations import activation_loader


class MLP(nn.Module):
    def __init__(self, in_dim: int, hidden_dims: Sequence[int], activation: str = "relu"):
        super().__init__()
        dims = [in_dim, *hidden_dims]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.act = activation_loader(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = self.act(x)
        return x
