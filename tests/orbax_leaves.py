"""Leaves of checkpoint trees, compared bit for bit: the orbax tests' helpers
(no JAX import, so a process without JAX can use them)."""

import numpy as np
import torch


def leaves(tree, prefix=()):
    """``(path, leaf)`` of a checkpoint tree: dicts by sorted key, lists and
    tuples by index, None and empty containers as leaves."""
    if isinstance(tree, dict) and tree:
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)) and tree:
        for i, v in enumerate(tree):
            yield from leaves(v, prefix + (str(i),))
    else:
        yield prefix, tree


def bits(leaf):
    """A leaf as a numpy array whose equality is bitwise: bfloat16 (a torch
    tensor from the port, ml_dtypes from the JAX package) as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        assert leaf.dtype == torch.bfloat16
        return leaf.view(torch.int16).numpy().view(np.uint16)
    arr = np.asarray(leaf)
    return arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr


def is_empty(leaf) -> bool:
    return leaf is None or (isinstance(leaf, (dict, list, tuple)) and not leaf)


def fixture_arrays(payload: dict) -> dict:
    """Every array leaf of a payload's trees keyed by its path joined with
    ``/`` (``params/...``, ``opt_state/1/mu/...``, ``ema_params/...``)."""
    return {"/".join((part,) + p): bits(v) for part in ("params", "opt_state", "ema_params")
            for p, v in leaves(payload[part]) if not is_empty(v)}
