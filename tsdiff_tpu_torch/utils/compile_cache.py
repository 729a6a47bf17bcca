"""Persistent build cache of the port's compiled libraries.

Port of ``tsdiff_tpu/utils/compile_cache.py``.  What a process of the port
compiles, and can keep for the next one, is its shared libraries: the CUDA
kernels of ``csrc/*.cu`` (``ops/_build.py``, one ``nvcc`` each, about a
minute together) and the C++ batch packer (``data/native.py``).  Both are
cached under a build root, keyed by a hash of their source and flags, so a
process that finds a library there loads it and compiles nothing.  The
default root is ``tsdiff_tpu_torch/_build/``; ``enable_compile_cache(path)``
points both at ``path``, for a cache that outlives the checkout or is shared
by its processes.

CUDA graphs are not kept: each process records its own (a graph holds the
addresses of its process's memory).

Enable explicitly via ``enable_compile_cache(path)`` or ambiently via the
``TSDIFF_COMPILE_CACHE`` environment variable (the sampling, protein-sampling
and train CLIs call :func:`maybe_enable_compile_cache` at start-up, the
service with its ``--compile_cache``).
"""

from __future__ import annotations

import os

from tsdiff_tpu_torch.data import native
from tsdiff_tpu_torch.ops import _build

ENV = "TSDIFF_COMPILE_CACHE"


def build_roots() -> dict[str, str]:
    """Where the kernel libraries and the packer are built and found."""
    return {"kernels": _build.BUILD_ROOT, "packer": native.BUILD_ROOT}


def enable_compile_cache(path: str) -> bool:
    """Point the kernels' and the packer's build roots at ``path`` (created
    if needed); returns True.  Call it before the process's first build:
    it raises if a library was already loaded from another root."""
    path = os.path.abspath(path)
    loaded = {"kernels": bool(_build._loaded), "packer": native._lib is not None}
    for what, root in build_roots().items():
        if loaded[what] and os.path.abspath(root) != path:
            raise RuntimeError(f"the {what} library was already loaded from {root}: enable the "
                               f"compile cache at {path} before the first build")
    os.makedirs(path, exist_ok=True)
    _build.BUILD_ROOT = native.BUILD_ROOT = path
    return True


def maybe_enable_compile_cache(path: str | None = None) -> bool:
    """Enable the cache from an explicit path or ``TSDIFF_COMPILE_CACHE``;
    no-op (False) when neither is set."""
    path = path or os.environ.get(ENV)
    if not path:
        return False
    return enable_compile_cache(path)
