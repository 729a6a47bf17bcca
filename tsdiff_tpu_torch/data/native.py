"""ctypes binding of the native batch packer (``csrc/graphbuild.cpp``).

Port of ``tsdiff_tpu/data/native.py``.  The C++ source is compiled with
``g++ -O3 -fPIC -shared -std=c++17`` at first use into
``tsdiff_tpu_torch/_build/graphbuild-<hash>/libgraphbuild.so``, keyed by a
hash of the source and the flags (as ``ops/_build.py`` keys the CUDA
libraries), so an edited source is rebuilt and an unchanged one reused.  A
failed build raises with the compiler's output: there is no fallback.

:func:`pack_batch_native` has the output contract of the numpy packer in
``core/graph.py`` for graphs with sparse edges (``edge_index`` +
``edge_type``); ``from_numpy_graphs`` sends graphs with a dense
``bond_mat`` to the numpy packer, by their form.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "graphbuild.cpp")
BUILD_ROOT = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lib: ctypes.CDLL | None = None


def library_path() -> str:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_ROOT, f"graphbuild-{h.hexdigest()[:16]}", "libgraphbuild.so")


def build() -> str:
    """Compile the packer if its library is not built yet; returns its path.
    Raises ``RuntimeError`` with the compiler's output when the build fails."""
    so = library_path()
    if os.path.exists(so):
        return so
    cxx = os.environ.get("CXX") or "g++"
    if not shutil.which(cxx):
        raise RuntimeError(f"no C++ compiler ({cxx}; set $CXX): the native batch packer "
                           "cannot be built")
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"   # ranks of one run may build at once
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE} failed (exit {proc.returncode}):\n"
                           f"{proc.stderr}{proc.stdout}")
    os.replace(tmp, so)
    return so


def _load_library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.pack_batch.restype = ctypes.c_int32
        lib.pack_batch.argtypes = [
            i32p, f32p, f32p, f32p, i32p, i32p, i64p, i64p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i32p, f32p, f32p, f32p, i32p, u8p,
        ]
        _lib = lib
    return _lib


def native_available() -> bool:
    """True once the library is built and loaded; a failed build raises."""
    return _load_library() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _cat(arrays: list, dtype, tail: tuple) -> np.ndarray:
    if not arrays:
        return np.zeros((0, *tail), dtype)
    return np.ascontiguousarray(np.concatenate([np.asarray(a, dtype) for a in arrays], axis=0))


def pack_batch_native(graphs: list[dict], max_nodes: int):
    """Pack graph dicts with sparse edges into padded numpy buffers with the
    C++ packer: ``(atom_type int32 (B, N), r_feat float32 (B, N, F), p_feat,
    pos float32 (B, N, 3), bond_mat int32 (B, N, N), node_mask bool (B, N))``.
    Raises ``ValueError`` when a graph exceeds ``max_nodes`` or an edge
    leaves its graph."""
    lib = _load_library()
    B, N = len(graphs), int(max_nodes)
    F = int(np.asarray(graphs[0]["r_feat"]).shape[-1])
    sizes = [int(np.asarray(g["atom_type"]).shape[0]) for g in graphs]
    node_off = np.zeros(B + 1, np.int64)
    node_off[1:] = np.cumsum(sizes)
    edge_off = np.zeros(B + 1, np.int64)
    edge_off[1:] = np.cumsum([np.asarray(g["edge_type"]).shape[0] for g in graphs])

    atom_cat = _cat([g["atom_type"] for g in graphs], np.int32, ())
    rf_cat = _cat([g["r_feat"] for g in graphs], np.float32, (F,))
    pf_cat = _cat([g["p_feat"] for g in graphs], np.float32, (F,))
    pos_cat = _cat([g["pos"] if g.get("pos") is not None else np.zeros((n, 3), np.float32)
                    for g, n in zip(graphs, sizes)], np.float32, (3,))
    # edges as (sum_e, 2) row pairs
    ei_cat = _cat([np.asarray(g["edge_index"], np.int32).T for g in graphs], np.int32, (2,))
    et_cat = _cat([g["edge_type"] for g in graphs], np.int32, ())

    out_atom = np.zeros((B, N), np.int32)
    out_rf = np.zeros((B, N, F), np.float32)
    out_pf = np.zeros((B, N, F), np.float32)
    out_pos = np.zeros((B, N, 3), np.float32)
    out_bond = np.zeros((B, N, N), np.int32)
    out_mask = np.zeros((B, N), np.uint8)
    rc = lib.pack_batch(
        _ptr(atom_cat, ctypes.c_int32), _ptr(rf_cat, ctypes.c_float),
        _ptr(pf_cat, ctypes.c_float), _ptr(pos_cat, ctypes.c_float),
        _ptr(ei_cat, ctypes.c_int32), _ptr(et_cat, ctypes.c_int32),
        _ptr(node_off, ctypes.c_int64), _ptr(edge_off, ctypes.c_int64),
        B, N, F,
        _ptr(out_atom, ctypes.c_int32), _ptr(out_rf, ctypes.c_float),
        _ptr(out_pf, ctypes.c_float), _ptr(out_pos, ctypes.c_float),
        _ptr(out_bond, ctypes.c_int32), _ptr(out_mask, ctypes.c_uint8),
    )
    if rc != 0:
        raise ValueError(f"pack_batch failed (rc={rc}): a graph exceeds max_nodes={N} "
                         "or an edge index lies outside its graph")
    return out_atom, out_rf, out_pf, out_pos, out_bond, out_mask.astype(bool)
