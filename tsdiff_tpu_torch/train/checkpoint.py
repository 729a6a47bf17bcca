"""Checkpoints: ``tsdiff_tpu.ckpt.v1`` pickles, read and written, and the
reference's torch ``.pt`` files, read.

A checkpoint is a self-describing pickle of plain numpy arrays:
``{"format": "tsdiff_tpu.ckpt.v1", "config": {...}, "params": <flax tree>,
"opt_state": ..., "ema_params": <flax tree> | None, ...}``.  The parameter
trees stay in flax layout here; ``tsdiff_tpu_torch.convert`` maps them to and
from a torch ``state_dict``, so the JAX package loads what the port writes.

``opt_state`` is written in the JAX package's layout, the optax chain
``clip_by_global_norm -> scale_by_adam [-> add_decayed_weights]`` as plain
containers: ``((), {"count": int32, "mu": <flax tree>, "nu": <flax tree>}
[, ()])``, the moments with the same tree shape and the same ``(in, out)``
kernels as ``params``.  The JAX package's ``restore_opt_state`` pours the
leaves of such a state into its optax template in sorted-key order, so each
moment lands on its own parameter.  ``opt_state_from_checkpoint`` reads that
layout, a state the JAX package wrote (optax NamedTuples) and the
``{"count", "mu", "nu"}`` dict keyed by torch names that earlier versions of
the port wrote.

Checkpoint pickles are read by a restricted unpickler: numpy's globals load,
optax's state classes load as stand-ins (``OptaxState``), so a checkpoint the
JAX package wrote loads where neither JAX nor optax is installed, and any
other global is refused.  A torch zip container (a reference ``<iter>.pt``)
is converted in memory by ``data/convert.py``.  A directory is an orbax
checkpoint (``<iter>.orbax``, written by the JAX package's or the port's
``--ckpt_backend orbax``), read by ``train/orbax_io.py`` into the same
payload: orbax restores the optax chain's tuples as lists, an optax
``EmptyState`` as None, and older orbax versions tuples as dicts keyed
``"0"``, ``"1"``, ...
"""

from __future__ import annotations

import os
import pickle
import zipfile

import numpy as np
import torch

from tsdiff_tpu_torch.convert import params_from_jax, params_to_jax

CKPT_FORMAT = "tsdiff_tpu.ckpt.v1"

#: field names of the optax states the JAX package's optimizer chain holds
#: (a NamedTuple pickles its values by position only)
OPTAX_FIELDS = {"ScaleByAdamState": ("count", "mu", "nu")}
_ADAM_FIELDS = OPTAX_FIELDS["ScaleByAdamState"]


class OptaxState(tuple):
    """Stand-in for an optax state NamedTuple: its values by position, with
    the field names in ``_fields`` where ``OPTAX_FIELDS`` knows the class."""

    _fields: tuple = ()

    def __new__(cls, *values):
        return super().__new__(cls, values)


_STAND_INS: dict[tuple[str, str], type] = {}


def _optax_stand_in(module: str, name: str) -> type:
    key = (module, name)
    if key not in _STAND_INS:
        _STAND_INS[key] = type(name, (OptaxState,), {"_fields": OPTAX_FIELDS.get(name, ()),
                                                     "__module__": module})
    return _STAND_INS[key]


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        root = module.partition(".")[0]
        if root == "numpy":
            return super().find_class(module, name)
        if root == "optax":
            return _optax_stand_in(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint pickle references {module}.{name}, which a checkpoint does not hold"
        )


def is_torch_zip(path: str) -> bool:
    """A torch>=1.6 zip container: a zip with an ``<archive>/data.pkl``
    member (``zipfile.is_zipfile`` alone also accepts a pickle that embeds
    zip bytes)."""
    if not zipfile.is_zipfile(path):
        return False
    try:
        with zipfile.ZipFile(path) as zf:
            return any(n == "data.pkl" or n.endswith("/data.pkl") for n in zf.namelist())
    except zipfile.BadZipFile:
        return False


def load_checkpoint(path: str) -> dict:
    """Load a ``tsdiff_tpu.ckpt.v1`` pickle, an orbax checkpoint directory,
    or a reference torch ``.pt`` converted in memory; raise on any other
    format."""
    if os.path.isdir(path):
        from tsdiff_tpu_torch.train.orbax_io import load_checkpoint_orbax

        return load_checkpoint_orbax(path)
    if is_torch_zip(path):
        from tsdiff_tpu_torch.data.convert import convert_reference_checkpoint

        return convert_reference_checkpoint(path)
    with open(path, "rb") as f:
        payload = _CheckpointUnpickler(f).load()
    if not (isinstance(payload, dict) and payload.get("format") == CKPT_FORMAT):
        raise ValueError(
            f"unrecognized checkpoint format in {path}: expected a {CKPT_FORMAT} pickle or a "
            "torch>=1.6 zip-container .pt file"
        )
    return payload


def select_params(ck: dict, use_ema: bool) -> tuple[dict, bool]:
    """``(params, used_ema)``: the EMA weights when asked for AND present,
    else the raw params."""
    if use_ema and ck.get("ema_params") is not None:
        return ck["ema_params"], True
    return ck["params"], False


def opt_state_to_jax(opt: dict, weight_decay: float = 0.0) -> tuple:
    """The port's Adam state in the JAX package's optax-chain layout."""
    adam = {"count": np.asarray(int(opt["count"]), dtype=np.int32),
            "mu": params_to_jax(opt["mu"]), "nu": params_to_jax(opt["nu"])}
    return ((), adam, ()) if weight_decay else ((), adam)


def checkpoint_payload(config, state, scheduler_state: dict | None = None,
                       iteration: int | None = None, avg_val_loss: float | None = None) -> dict:
    """The checkpoint payload of ``state`` (a ``train.trainer.TrainState``):
    the parameter trees in flax layout and the optimizer state in the optax
    chain's, as numpy arrays; the pickle and orbax backends both write it."""
    cfg = config.to_dict() if hasattr(config, "to_dict") else dict(config)
    weight_decay = cfg.get("train", {}).get("optimizer", {}).get("weight_decay", 0.0)
    return {
        "format": CKPT_FORMAT,
        "config": cfg,
        "params": params_to_jax(state.params),
        "opt_state": opt_state_to_jax(state.opt_state, weight_decay),
        "ema_params": None if state.ema_params is None else params_to_jax(state.ema_params),
        "scheduler": scheduler_state,
        "iteration": int(iteration if iteration is not None else state.step),
        "avg_val_loss": avg_val_loss,
    }


def save_checkpoint(path: str, config, state, scheduler_state: dict | None = None,
                    iteration: int | None = None, avg_val_loss: float | None = None) -> None:
    """Write ``state`` (a ``train.trainer.TrainState``) as a self-describing
    pickle, atomically."""
    payload = checkpoint_payload(config, state, scheduler_state, iteration, avg_val_loss)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def _chain_entries(opt) -> list:
    """The optax chain's states in order: a tuple or list, or a dict keyed
    ``"0"``, ``"1"``, ... ordered by number (``"10"`` after ``"9"``), as the
    JAX package's ``_ordered_leaves`` orders them."""
    if isinstance(opt, dict):
        return [opt[k] for k in sorted(opt, key=int)]
    return list(opt)


def _adam_entry(opt):
    """``(count, mu, nu)`` of the chain entry that carries Adam's state, by
    field name: a dict entry (the port's layout, or an optax state as orbax
    restores it) or an optax state; the chain's empty states (``()``, or None
    from orbax) hold none."""
    for entry in _chain_entries(opt):
        if entry is None:
            continue
        if not isinstance(entry, dict):
            entry = dict(zip(getattr(entry, "_fields", ()), entry))
        if set(_ADAM_FIELDS) <= set(entry):
            return tuple(entry[k] for k in _ADAM_FIELDS)
    raise ValueError("the checkpoint's opt_state holds no Adam state (count, mu, nu)")


def opt_state_from_checkpoint(ck: dict, device) -> dict:
    """The port's Adam state from a checkpoint: the JAX layout (the port's
    own, or optax states the JAX package wrote), or the dict of torch-named
    moments that earlier versions of the port wrote."""
    opt = ck.get("opt_state")
    if isinstance(opt, dict) and set(_ADAM_FIELDS) <= set(opt):
        count, mu, nu = (opt[k] for k in _ADAM_FIELDS)
        moments = [{k: torch.from_numpy(np.array(v)) for k, v in m.items()} for m in (mu, nu)]
    elif isinstance(opt, (tuple, list)) or (isinstance(opt, dict) and opt
                                            and all(str(k).isdigit() for k in opt)):
        count, mu, nu = _adam_entry(opt)
        moments = [params_from_jax(m) for m in (mu, nu)]
    else:
        raise ValueError("the checkpoint carries no optimizer state to resume from")
    return {"count": int(count),
            **{k: {n: t.to(device) for n, t in m.items()} for k, m in zip(("mu", "nu"), moments)}}


def get_checkpoint_path(ckpt_dir: str, it: int | None = None) -> tuple[str, int]:
    """The latest (or the given) ``<iteration>.ckpt`` file or
    ``<iteration>.orbax`` directory of a directory."""
    entries = {}
    for f in os.listdir(ckpt_dir):
        stem, _, ext = f.partition(".")
        if ext in ("ckpt", "orbax") and stem.isdigit():
            entries[int(stem)] = f
    if not entries:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    chosen = it if it is not None else max(entries)
    if chosen not in entries:
        raise FileNotFoundError(f"no checkpoint for iteration {chosen} in {ckpt_dir}")
    return os.path.join(ckpt_dir, entries[chosen]), chosen
