"""Checkpoint loading: ``tsdiff_tpu.ckpt.v1`` pickles.

A checkpoint is a self-describing pickle of plain numpy arrays:
``{"format": "tsdiff_tpu.ckpt.v1", "config": {...}, "params": <flax tree>,
"ema_params": <flax tree> | None, ...}``.  Unpickling it needs only numpy.
The parameter trees stay in flax layout here; ``tsdiff_tpu_torch.convert``
maps them to a torch ``state_dict``.

Orbax directories and reference torch ``.pt`` files are not read yet.
"""

from __future__ import annotations

import os
import pickle

CKPT_FORMAT = "tsdiff_tpu.ckpt.v1"


def load_checkpoint(path: str) -> dict:
    """Load a ``tsdiff_tpu.ckpt.v1`` pickle; raise on any other format."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path}: orbax checkpoint directories are not ported yet"
        )
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if not (isinstance(payload, dict) and payload.get("format") == CKPT_FORMAT):
        raise ValueError(
            f"unrecognized checkpoint format in {path}: expected a "
            f"{CKPT_FORMAT} pickle (orbax and .pt checkpoints are not ported yet)"
        )
    return payload


def select_params(ck: dict, use_ema: bool) -> tuple[dict, bool]:
    """``(params, used_ema)``: the EMA weights when asked for AND present,
    else the raw params."""
    if use_ema and ck.get("ema_params") is not None:
        return ck["ema_params"], True
    return ck["params"], False
