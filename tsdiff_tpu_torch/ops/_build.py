"""Build the CUDA kernels of ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds).  The
library goes to ``tsdiff_tpu_torch/_build/<name>-<hash>/``, keyed by a hash
of the source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source is rebuilt and an unchanged one is reused.  Several sources build in
parallel, one ``nvcc`` each.

Nothing here runs at import time; without ``nvcc`` a build raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: appended to NVCC_FLAGS by build() and hashed with them: set before the first
#: build of a process (ops/wg_profile.py sets ("-DWG_PROFILE",))
extra_flags: tuple[str, ...] = ()

_loaded: dict[str, ctypes.CDLL] = {}
#: per library: {"seconds": build time (0.0 when reused), "log": nvcc output}
build_info: dict[str, dict] = {}


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _paths(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *extra_flags)).encode())
    # the source and every shared header it may include
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    out_dir = os.path.join(BUILD_ROOT, f"{name}-{digest}")
    return src, os.path.join(out_dir, f"lib{name}.so")


def build(names: list[str]) -> None:
    """Compile every library in ``names`` that is not built yet, all
    ``nvcc`` processes started together; raise if any fails."""
    pending = []
    for name in names:
        src, so = _paths(name)
        if os.path.exists(so):
            build_info.setdefault(name, {"seconds": 0.0, "log": ""})
            continue
        os.makedirs(os.path.dirname(so), exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", tmp, src]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        pending.append((name, so, tmp, proc, time.monotonic()))
    errors = []
    for name, so, tmp, proc, t0 in pending:
        log, _ = proc.communicate()
        build_info[name] = {"seconds": time.monotonic() - t0, "log": log}
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(_paths(name)[1])
    return _loaded[name]
