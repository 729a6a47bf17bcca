"""Dot-access configuration, as checkpoints embed it: a dict with attribute
access, recursively applied to nested mappings, with ``config.get(key,
default)`` for optional keys.

``load_config`` reads ``.json`` with the standard library, and ``.yml`` /
``.yaml`` with PyYAML when it is installed (a machine without it needs JSON
configs)."""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

CONFIG_SUFFIXES = (".json", ".yml", ".yaml")


class Config(dict):
    """A dict with attribute access, recursively applied to nested mappings."""

    def __init__(self, d: Mapping[str, Any] | None = None, **kwargs):
        super().__init__()
        for k, v in {**(d or {}), **kwargs}.items():
            self[k] = v

    @staticmethod
    def _wrap(value):
        if isinstance(value, Mapping) and not isinstance(value, Config):
            return Config(value)
        if isinstance(value, (list, tuple)):
            return type(value)(Config._wrap(v) for v in value)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, Config._wrap(value))

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def to_dict(self) -> dict:
        """Plain-dict (JSON, YAML and pickle friendly) copy."""

        def unwrap(v):
            if isinstance(v, dict):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(unwrap(x) for x in v)
            return v

        return unwrap(self)


def load_config(path: str) -> Config:
    """A config file: JSON, or YAML when PyYAML is installed."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in CONFIG_SUFFIXES:
        raise ValueError(f"{path}: config files are {', '.join(CONFIG_SUFFIXES)}")
    with open(path) as f:
        if ext == ".json":
            return Config(json.load(f))
        try:
            import yaml
        except ImportError:
            raise RuntimeError(
                f"{path}: reading YAML needs PyYAML, which is not installed; "
                "write the config as JSON instead"
            ) from None
        return Config(yaml.safe_load(f))
