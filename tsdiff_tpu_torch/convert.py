"""Weights carried across between a flax parameter tree and a torch
``state_dict``, both ways (``params_from_jax``, ``params_to_jax``).

The flax tree of a condensed-encoder checkpoint looks like::

    params/edge_enc/mlp/layers_1/Dense_0/kernel   (in, out)
    params/edge_enc/bond_emb/embedding            (vocab, H)
    params/encoder/stack/f1w                      (L, H, F)

and a dual encoder's adds, per branch, ``encoder_global/node_emb`` and
``encoder_global/stack/*`` (SchNet), ``encoder_local/node_emb`` and
``encoder_local/convs_<i>/nn/layers_<j>`` (GIN), the edge encoders
``edge_encoder_{global,local}``, the heads ``grad_{global,local}_dist_mlp``
and in TS mode ``edge_cat_{global,local}/lin{0,1}``.  They map to torch names
by these rules:

* the ``Dense_0`` level disappears, and ``layers_<i>`` and ``convs_<i>``
  become ``layers.<i>`` and ``convs.<i>`` (an ``nn.ModuleList``);
* a ``kernel`` becomes the ``weight`` of an ``nn.Linear``, transposed from
  flax ``(in, out)`` to torch ``(out, in)``;
* an ``embedding`` becomes the ``weight`` of an ``nn.Embedding`` (same layout);
* every other leaf — the layer-stacked ``encoder/stack/*`` arrays — keeps its
  name and its stacked flax layout.

The optional encoders (EGNN, DimeNet++, ComENet) add flax ``LayerNorm``
leaves (``scale``, ``bias``: a torch ``nn.LayerNorm``'s ``weight`` and
``bias``), kernels of a flax ``nn.Dense`` used directly, with no ``Dense_0``
level (a ``models.mlp.Dense``), and bare parameters that keep their name and
layout (``dist_emb/freq``, ``lin_sbf1``, GraphNorm's ``alpha``/``gamma``/
``beta``).

The way back needs to know what each ``weight`` is.  Given the torch
``module``, ``params_to_jax`` reads it from the module types; without it,
the modules named in ``EMBEDDINGS`` hold embeddings and every other
``weight``/``bias`` pair is a linear layer's ``Dense_0`` kernel and bias,
which covers the condensed and dual encoders.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_LAYER = re.compile(r"^(layers|convs)_(\d+)$")
#: torch modules whose ``weight`` is a flax ``embedding``
EMBEDDINGS = ("atom_embedding", "bond_emb", "node_emb")


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
        parts.extend((m.group(1), m.group(2)) if m else (p,))
    if parts[-1] in ("kernel", "embedding", "scale"):
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


def param_kinds(module: torch.nn.Module) -> dict[str, str]:
    """Torch parameter name -> the flax leaf kind of its module: ``dense`` (a
    ``models.mlp.Dense``), ``linear`` (any other ``nn.Linear``, under a
    ``Dense_0``), ``layer_norm`` or ``embedding``; bare parameters absent."""
    from torch import nn

    from tsdiff_tpu_torch.models.mlp import Dense

    kinds = {}
    for mname, m in module.named_modules():
        kind = ("dense" if isinstance(m, Dense) else "linear" if isinstance(m, nn.Linear)
                else "layer_norm" if isinstance(m, nn.LayerNorm)
                else "embedding" if isinstance(m, nn.Embedding) else None)
        if kind is not None:
            for pname, _ in m.named_parameters(recurse=False):
                kinds[f"{mname}.{pname}" if mname else pname] = kind
    return kinds


_LEAVES = {"dense": {"weight": ["kernel"], "bias": ["bias"]},
           "linear": {"weight": ["Dense_0", "kernel"], "bias": ["Dense_0", "bias"]},
           "layer_norm": {"weight": ["scale"], "bias": ["bias"]},
           "embedding": {"weight": ["embedding"]}}


def flax_path(name: str, kinds: Mapping[str, str] | None = None) -> tuple[str, ...]:
    """Flax leaf path of a torch parameter name (the inverse of
    ``torch_name``); ``kinds``: ``param_kinds`` of the module."""
    parts = name.split(".")
    path = []
    for i, p in enumerate(parts):
        if p.isdigit() and i and parts[i - 1] in ("layers", "convs"):
            path[-1] = f"{parts[i - 1]}_{p}"
        else:
            path.append(p)
    if kinds is not None:
        if name in kinds:
            path[-1:] = _LEAVES[kinds[name]][path[-1]]
    elif path[-1] == "weight" and path[-2] in EMBEDDINGS:
        path[-1] = "embedding"
    elif path[-1] == "weight":
        path[-1:] = ["Dense_0", "kernel"]
    elif path[-1] == "bias":
        path[-1:] = ["Dense_0", "bias"]
    return tuple(path)


def params_to_jax(state_dict: Mapping[str, torch.Tensor],
                  module: torch.nn.Module | None = None) -> dict:
    """Torch ``state_dict`` -> flax parameter tree ``{"params": {...}}`` of
    float32 numpy arrays, kernels transposed back to flax ``(in, out)``; the
    exact inverse of ``params_from_jax``.  ``module``: the model the state
    comes from, which says what each parameter is (needed for the optional
    encoders)."""
    kinds = None if module is None else param_kinds(module)
    tree: dict = {}
    for name, t in state_dict.items():
        arr = t.detach().to("cpu", torch.float32).numpy()
        path = flax_path(name, kinds)
        if path[-1] == "kernel":
            arr = arr.T
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        if path[-1] in node:
            raise ValueError(f"two torch names map to flax path {'/'.join(path)}")
        node[path[-1]] = np.ascontiguousarray(arr)
    return {"params": tree}
