"""Infra utilities: device resolution, seeding, log directories, logging,
mapping over nested tensors."""

from __future__ import annotations

import dataclasses
import logging
import os
import random
import time

import numpy as np
import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on.  CUDA is the default; the CPU is
    used only when the caller names it.  Asking for CUDA without a card
    raises instead of falling back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' (--device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def get_logger(name: str, log_dir: str | None = None) -> logging.Logger:
    """Console + optional file logger.  A later call with another ``log_dir``
    (a second run in the same process) moves the file handler there."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    formatter = logging.Formatter("[%(asctime)s::%(name)s::%(levelname)s] %(message)s")
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        sh = logging.StreamHandler()
        sh.setLevel(logging.INFO)
        sh.setFormatter(formatter)
        logger.addHandler(sh)
    if log_dir is None:
        return logger
    path = os.path.abspath(os.path.join(log_dir, "log.txt"))
    for h in [h for h in logger.handlers if isinstance(h, logging.FileHandler)]:
        if h.baseFilename != path:
            logger.removeHandler(h)
            h.close()
    if not any(isinstance(h, logging.FileHandler) for h in logger.handlers):
        fh = logging.FileHandler(path)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    return logger


def seed_all(seed: int) -> None:
    """Seed Python, numpy and torch's global generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def get_new_log_dir(root: str = "./logs", prefix: str = "", tag: str = "") -> str:
    """A new timestamped run directory under ``root``."""
    fn = time.strftime("%Y_%m_%d__%H_%M_%S", time.localtime())
    if prefix:
        fn = f"{prefix}_{fn}"
    if tag:
        fn = f"{fn}_{tag}"
    log_dir = os.path.join(root, fn)
    os.makedirs(log_dir, exist_ok=True)
    return log_dir


def count_parameters(model: torch.nn.Module) -> int:
    """Number of scalars in a module's parameters."""
    return sum(t.numel() for t in model.parameters())


def map_tree(fn, x):
    """``fn`` of every tensor or numpy array in ``x`` (a tensor, an array, or
    a dataclass, dict, list or tuple of them); other leaves kept."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return fn(x)
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: map_tree(fn, getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: map_tree(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(map_tree(fn, v) for v in x)
    return x
