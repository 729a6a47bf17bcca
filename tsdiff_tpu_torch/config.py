"""Dot-access configuration, as checkpoints embed it: a dict with attribute
access, recursively applied to nested mappings, with ``config.get(key,
default)`` for optional keys."""

from __future__ import annotations

from typing import Any, Mapping


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
