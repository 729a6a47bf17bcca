"""Weights carried across: flax parameter tree -> torch ``state_dict``.

The flax tree of a condensed-encoder checkpoint looks like::

    params/edge_enc/mlp/layers_1/Dense_0/kernel   (in, out)
    params/edge_enc/bond_emb/embedding            (vocab, H)
    params/encoder/stack/f1w                      (L, H, F)

and maps to torch names by these rules:

* the ``Dense_0`` level disappears and ``layers_<i>`` becomes ``layers.<i>``
  (an ``nn.ModuleList``);
* a ``kernel`` becomes the ``weight`` of an ``nn.Linear``, transposed from
  flax ``(in, out)`` to torch ``(out, in)``;
* an ``embedding`` becomes the ``weight`` of an ``nn.Embedding`` (same layout);
* every other leaf — the layer-stacked ``encoder/stack/*`` arrays — keeps its
  name and its stacked flax layout.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_LAYER = re.compile(r"^layers_(\d+)$")


def _leaves(tree: Mapping, prefix: tuple = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def torch_name(path: tuple) -> str:
    """Torch parameter name of a flax leaf path."""
    parts = []
    for p in path:
        if p == "Dense_0":
            continue
        m = _LAYER.match(p)
        parts.extend(("layers", m.group(1)) if m else (p,))
    if parts[-1] in ("kernel", "embedding"):
        parts[-1] = "weight"
    return ".".join(parts)


def params_from_jax(params_tree: Mapping) -> dict[str, torch.Tensor]:
    """Flax parameter tree (numpy arrays) -> torch ``state_dict`` (float32
    CPU tensors).  Accepts the tree with or without its top ``params`` key."""
    if "params" in params_tree and isinstance(params_tree["params"], Mapping):
        params_tree = params_tree["params"]
    out = {}
    for path, value in _leaves(params_tree):
        arr = np.asarray(value, dtype=np.float32)
        if path[-1] == "kernel":
            arr = arr.T
        name = torch_name(path)
        if name in out:
            raise ValueError(f"two flax leaves map to torch name {name!r}")
        out[name] = torch.from_numpy(np.array(arr))  # a writable, contiguous copy
    return out
