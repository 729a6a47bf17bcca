"""Checkpoints: ``tsdiff_tpu.ckpt.v1`` pickles, read and written.

A checkpoint is a self-describing pickle of plain numpy arrays:
``{"format": "tsdiff_tpu.ckpt.v1", "config": {...}, "params": <flax tree>,
"ema_params": <flax tree> | None, ...}``.  Unpickling it needs only numpy.
The parameter trees stay in flax layout here; ``tsdiff_tpu_torch.convert``
maps them to and from a torch ``state_dict``, so the JAX package loads what
the port writes.  ``opt_state`` is the port's own dict of numpy arrays
(``{"count", "mu", "nu"}``), which only the port resumes from.

Orbax directories and reference torch ``.pt`` files are not read yet.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from tsdiff_tpu_torch.convert import params_to_jax

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


def save_checkpoint(path: str, config, state, scheduler_state: dict | None = None,
                    iteration: int | None = None, avg_val_loss: float | None = None) -> None:
    """Write ``state`` (a ``train.trainer.TrainState``) as a self-describing
    pickle, atomically."""
    opt = state.opt_state
    payload = {
        "format": CKPT_FORMAT,
        "config": config.to_dict() if hasattr(config, "to_dict") else dict(config),
        "params": params_to_jax(state.params),
        "opt_state": {
            "count": int(opt["count"]),
            **{m: {k: v.detach().cpu().numpy() for k, v in opt[m].items()} for m in ("mu", "nu")},
        },
        "ema_params": None if state.ema_params is None else params_to_jax(state.ema_params),
        "scheduler": scheduler_state,
        "iteration": int(iteration if iteration is not None else state.step),
        "avg_val_loss": avg_val_loss,
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def opt_state_from_checkpoint(ck: dict, device) -> dict:
    """The port's optimizer state of a checkpoint the port wrote."""
    opt = ck.get("opt_state")
    if not (isinstance(opt, dict) and {"count", "mu", "nu"} <= set(opt)):
        raise NotImplementedError(
            "resuming the optimizer state of a checkpoint the JAX package wrote is not ported"
        )
    return {
        "count": int(opt["count"]),
        **{m: {k: torch.from_numpy(np.array(v)).to(device) for k, v in opt[m].items()}
           for m in ("mu", "nu")},
    }


def get_checkpoint_path(ckpt_dir: str, it: int | None = None) -> tuple[str, int]:
    """The latest (or the given) ``<iteration>.ckpt`` of a directory."""
    entries = {}
    for f in os.listdir(ckpt_dir):
        stem, _, ext = f.partition(".")
        if ext == "ckpt" and stem.isdigit():
            entries[int(stem)] = f
    if not entries:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    chosen = it if it is not None else max(entries)
    if chosen not in entries:
        raise FileNotFoundError(f"no checkpoint for iteration {chosen} in {ckpt_dir}")
    return os.path.join(ckpt_dir, entries[chosen]), chosen
