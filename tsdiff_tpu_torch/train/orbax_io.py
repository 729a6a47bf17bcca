"""Orbax checkpoint directories, read and written without JAX, orbax or
tensorstore.

Port of ``tsdiff_tpu/train/orbax_io.py``.  A checkpoint is a directory
``<iter>.orbax/`` holding the tree ``{"params", "opt_state"[, "ema_params"]}``
as orbax's ``StandardCheckpointHandler`` stores it, with ``<iter>.orbax.meta.json``
beside it (format, config, scheduler state, iteration, validation loss).
``load_checkpoint_orbax`` returns the payload dict of a ``.ckpt`` pickle, so
every entry point that takes a checkpoint takes either.

What orbax writes, and what is read here:

* ``_METADATA`` (JSON): ``tree_metadata``, one entry per leaf keyed by the
  leaf's key tuple, each key with its type (2: a dict key, 1: a sequence
  index) and the leaf's ``value_type`` (an array, a ``scalar``, or an empty
  ``None``/``Dict``/``List``/``Tuple``/``NamedTuple`` that stores nothing);
  ``use_ocdbt`` says where the arrays are.
* Each array is a zarr v2 array named by its keys joined with ``.``:
  ``<name>/.zarray`` (JSON: shape, chunks, dtype, compressor) and one value
  per chunk, ``<name>/<i>.<j>...`` (``0`` for a 0-dim array), each the chunk's
  C-order little-endian bytes, zstd-compressed or raw.
* ``use_ocdbt: false``: those keys are files under the directory.
* ``use_ocdbt: true`` (what orbax writes by default, and so the JAX package):
  they are the keys of a tensorstore OCDBT database rooted at the directory
  (``OcdbtReader``): ``manifest.ocdbt`` names the newest version's B-tree,
  whose nodes and out-of-line values lie in data files under ``d/`` and
  ``ocdbt.process_<i>/d/``.

The writer (``save_checkpoint_orbax``) writes the ``use_ocdbt: false``
layout with ``"compressor": null``, which orbax, and so the JAX package's
``load_checkpoint_orbax``, restores: no zstd encoder is needed.  The tree is
the ``.ckpt`` pickle's (``train/checkpoint.py::checkpoint_payload``).  The
save returns once the state's tensors are copied (on the card: cloned on the
current stream, so no later step or graph replay can reach them, then copied
to pinned host memory on a side stream); a writer thread waits for the copy,
writes into a temporary sibling directory and renames it to ``<iter>.orbax``.
``wait_for_saves`` is the barrier, and raises what a write raised.

zstd frames are decoded by the system's libzstd through ctypes (found by
``ctypes.util.find_library("zstd")``, else ``libzstd.so.1``); the library is
loaded at the first compressed value, and its absence raises naming it.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import json
import os
import shutil
import struct
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable

import numpy as np
import torch

FORMAT = "tsdiff_tpu.ckpt.orbax.v1"
#: ``_CHECKPOINT_METADATA``'s handler: the one the JAX package saves with
HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"
#: ``value_type`` of the empty values orbax stores no array for, and what
#: they restore as (a ``NamedTuple`` as None: orbax's default options)
EMPTY_VALUES = {"None": None, "Dict": dict, "List": list, "Tuple": tuple, "NamedTuple": None}
KEY_SEQUENCE, KEY_DICT = 1, 2


# -- zstd ---------------------------------------------------------------------

_zstd: ctypes.CDLL | None = None
#: the name the zstd decoder was loaded by, and the file (None until the
#: first frame)
zstd_library: str | None = None


class _ZstdBuffer(ctypes.Structure):   # ZSTD_inBuffer and ZSTD_outBuffer
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


def _libzstd() -> ctypes.CDLL:
    global _zstd, zstd_library
    if _zstd is None:
        name = ctypes.util.find_library("zstd") or "libzstd.so.1"
        try:
            lib = ctypes.CDLL(name)
        except OSError as e:
            raise OSError(f"libzstd ({name}) cannot be loaded: zstd-compressed orbax values "
                          f"cannot be decoded ({e})") from e
        lib.ZSTD_createDCtx.argtypes = []
        lib.ZSTD_createDCtx.restype = ctypes.c_void_p
        lib.ZSTD_freeDCtx.argtypes = [ctypes.c_void_p]
        lib.ZSTD_freeDCtx.restype = ctypes.c_size_t
        lib.ZSTD_decompressStream.argtypes = [ctypes.c_void_p, ctypes.POINTER(_ZstdBuffer),
                                              ctypes.POINTER(_ZstdBuffer)]
        lib.ZSTD_decompressStream.restype = ctypes.c_size_t
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        _zstd = lib
        zstd_library = f"{name} ({', '.join(_mapped('libzstd')) or 'path not found'})"
    return _zstd


def _mapped(stem: str) -> list[str]:
    """The files of this process's mappings whose name starts with ``stem``."""
    try:
        with open("/proc/self/maps") as f:
            return sorted({line.split()[-1] for line in f
                           if os.path.basename(line.split()[-1]).startswith(stem)})
    except OSError:
        return []


def zstd_decompress(data: bytes, size: int | None = None) -> bytes:
    """One zstd frame decoded with libzstd's streaming decoder (a frame need
    not state its size); ``size``, where given, must be the decoded length."""
    lib = _libzstd()
    ctx = lib.ZSTD_createDCtx()
    if not ctx:
        raise MemoryError("ZSTD_createDCtx failed")
    src = ctypes.create_string_buffer(data, len(data))
    inp = _ZstdBuffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
    parts, step = [], max(size or 0, 1 << 17)
    try:
        while True:
            dst = ctypes.create_string_buffer(step)
            out = _ZstdBuffer(ctypes.cast(dst, ctypes.c_void_p), step, 0)
            ret = lib.ZSTD_decompressStream(ctx, ctypes.byref(out), ctypes.byref(inp))
            if lib.ZSTD_isError(ret):
                raise ValueError(f"zstd: {lib.ZSTD_getErrorName(ret).decode()}")
            parts.append(dst.raw[:out.pos])
            if ret == 0:   # the frame is complete
                break
            if inp.pos == inp.size and out.pos < out.size:
                raise ValueError("zstd: the frame is truncated")
    finally:
        lib.ZSTD_freeDCtx(ctx)
    if inp.pos != inp.size:
        raise ValueError(f"zstd: {inp.size - inp.pos} bytes after the frame")
    result = b"".join(parts)
    if size is not None and len(result) != size:
        raise ValueError(f"zstd frame decoded to {len(result)} bytes, expected {size}")
    return result


# -- OCDBT --------------------------------------------------------------------

def _crc32c_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as OCDBT's footers hold it."""
    crc = 0xFFFFFFFF
    table = _CRC32C
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_NODE_MAGIC = 0x0CDB20DE
VERSION_NODE_MAGIC = 0x0CDB1234
_NO_LOCATION = 2**64 - 1   # an empty tree's root offset and length


class _Cursor:
    """Reads OCDBT's little-endian fields and LEB128 varints from a body."""

    def __init__(self, buf: bytes, what: str):
        self.buf, self.pos, self.what = buf, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError(f"{self.what}: truncated ({n} bytes wanted at {self.pos} of "
                             f"{len(self.buf)})")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.u8()
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint longer than 10 bytes")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.buf):
            raise ValueError(f"{self.what}: {len(self.buf) - self.pos} bytes left after the "
                             "last field")


def decode_ocdbt_file(blob: bytes, magic: int, what: str) -> bytes:
    """The body of one OCDBT manifest or node: the header (magic, length,
    version, compression) and the CRC-32C footer checked, zstd undone."""
    if len(blob) < 18:
        raise ValueError(f"{what}: {len(blob)} bytes, too short for an OCDBT file")
    got_magic, length = struct.unpack(">I", blob[:4])[0], struct.unpack("<Q", blob[4:12])[0]
    if got_magic != magic:
        raise ValueError(f"{what}: magic {got_magic:#010x}, expected {magic:#010x}")
    if length != len(blob):
        raise ValueError(f"{what}: header says {length} bytes, read {len(blob)}")
    stored = struct.unpack("<I", blob[-4:])[0]
    if crc32c(blob[:-4]) != stored:
        raise ValueError(f"{what}: CRC-32C mismatch (stored {stored:#010x}, computed "
                         f"{crc32c(blob[:-4]):#010x})")
    head = _Cursor(blob[12:-4], what)
    version = head.varint()
    if version != 0:
        raise ValueError(f"{what}: OCDBT format version {version} (only 0 is known)")
    compression = head.u8()
    body = blob[12 + head.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd_decompress(body)
    raise ValueError(f"{what}: unknown compression format {compression}")


def _data_file_table(c: _Cursor) -> list[str]:
    """The node's data files, each a path relative to the database root
    (base path and relative path together), prefix-compressed."""
    n = c.varint()
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    c.varints(n)   # base path lengths: the paths are used whole
    paths, prev = [], b""
    for i in range(n):
        prev = prev[:prefix[i]] + c.take(suffix[i])
        paths.append(prev.decode())
    return paths


def _versions(c: _Cursor, files: list[str]) -> list[dict]:
    """A version-tree leaf's versions, column by column."""
    n = c.varint()
    gens, heights = c.varints(n), [c.u8() for _ in range(n)]
    ids, offsets, lengths = c.varints(n), c.varints(n), c.varints(n)
    num_keys = c.varints(n)
    c.varints(n)   # tree bytes
    c.varints(n)   # indirect value bytes
    times = [c.u64() for _ in range(n)]
    return [dict(generation=gens[i], height=heights[i], commit_time=times[i],
                 num_keys=num_keys[i],
                 root=None if lengths[i] == _NO_LOCATION else (files[ids[i]], offsets[i],
                                                               lengths[i]))
            for i in range(n)]


def _version_refs(c: _Cursor, files: list[str], child_height: int | None) -> list[dict]:
    """References to version-tree nodes: the manifest's carry their heights
    last, an interior node's children are one below it (``child_height``)."""
    n = c.varint()
    gens, ids, offsets, lengths = c.varints(n), c.varints(n), c.varints(n), c.varints(n)
    c.varints(n)   # generations under each
    for _ in range(n):
        c.u64()    # commit times
    heights = [c.u8() for _ in range(n)] if child_height is None else [child_height] * n
    return [dict(generation=gens[i], height=heights[i], location=(files[ids[i]], offsets[i],
                                                                    lengths[i]))
            for i in range(n)]


class OcdbtReader:
    """The newest version of a tensorstore OCDBT database in directory
    ``root``: its config, its versions, and every key with its value.

    Reads the manifest (``manifest.ocdbt``; orbax writes no numbered
    manifests, and those raise), then walks the newest version's B-tree from
    its root: interior nodes hold each child's first key and the common
    prefix of the child's keys (which the child leaves out), leaf nodes hold
    each value inline or as (data file, offset, length).  Every manifest and
    node's CRC-32C is checked."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        body = self._manifest_body("manifest.ocdbt")
        c = _Cursor(body, "manifest.ocdbt")
        self.config = self._config(c)
        if self.config["manifest_kind"] != 0:
            raise ValueError(f"{self.root}: manifest kind {self.config['manifest_kind']} (only "
                             "single manifests, as orbax writes them, are read)")
        files = _data_file_table(c)
        self.versions = _versions(c, files)
        self.version_nodes = _version_refs(c, files, None)
        c.end()
        if not self.versions:
            raise ValueError(f"{self.root}: the manifest holds no version")
        self.latest = max(self.versions, key=lambda v: v["generation"])

    def _manifest_body(self, name: str) -> bytes:
        with open(os.path.join(self.root, name), "rb") as f:
            return decode_ocdbt_file(f.read(), MANIFEST_MAGIC, os.path.join(self.root, name))

    @staticmethod
    def _config(c: _Cursor) -> dict:
        cfg = dict(uuid=c.take(16).hex(), manifest_kind=c.varint(),
                   max_inline_value_bytes=c.varint(), max_decoded_node_bytes=c.varint(),
                   version_tree_arity_log2=c.u8())
        method = c.varint()
        if method == 0:
            cfg["compression"] = None
        elif method == 1:
            cfg["compression"] = {"id": "zstd", "level": struct.unpack("<i", c.take(4))[0]}
        else:
            raise ValueError(f"{c.what}: unknown compression method {method}")
        return cfg

    def read_at(self, location: tuple[str, int, int]) -> bytes:
        path, offset, length = location
        with open(os.path.join(self.root, path), "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"{path}: {length} bytes at {offset} wanted, {len(data)} there")
        return data

    def version_tree(self, ref: dict) -> list[dict]:
        """Every version under a version-tree node reference of the
        manifest (``version_nodes``), oldest first."""
        where = "%s:%d:%d" % ref["location"]
        c = _Cursor(decode_ocdbt_file(self.read_at(ref["location"]), VERSION_NODE_MAGIC,
                                      where), where)
        c.u8()   # arity (log2)
        height = c.u8()
        if height != ref["height"]:
            raise ValueError(f"{where}: version node of height {height}, expected "
                             f"{ref['height']}")
        files = _data_file_table(c)
        if height == 0:
            out = _versions(c, files)
            c.end()
            return out
        refs = _version_refs(c, files, height - 1)
        c.end()
        return [v for r in refs for v in self.version_tree(r)]

    def items(self) -> dict[bytes, bytes]:
        """Every key of the newest version and its value, in key order."""
        out: dict[bytes, bytes] = {}
        root = self.latest["root"]
        if root is not None:
            self._walk(root, self.latest["height"], b"", out)
        if len(out) != self.latest["num_keys"]:
            raise ValueError(f"{self.root}: read {len(out)} keys, the manifest counts "
                             f"{self.latest['num_keys']}")
        return out

    def _walk(self, location, height: int, prefix: bytes, out: dict) -> None:
        where = "%s:%d:%d" % location
        c = _Cursor(decode_ocdbt_file(self.read_at(location), BTREE_NODE_MAGIC, where), where)
        got = c.u8()
        if got != height:
            raise ValueError(f"{where}: B-tree node of height {got}, expected {height}")
        files = _data_file_table(c)
        n = c.varint()
        key_prefix = [0] + c.varints(n - 1) if n else []
        key_suffix = c.varints(n)
        if height:
            common = c.varints(n)
        keys, prev = [], b""
        for i in range(n):
            prev = prev[:key_prefix[i]] + c.take(key_suffix[i])
            keys.append(prev)
        if height:
            ids, offsets, lengths = c.varints(n), c.varints(n), c.varints(n)
            c.varints(3 * n)   # keys, tree bytes and indirect bytes under each child
            c.end()
            for i in range(n):
                self._walk((files[ids[i]], offsets[i], lengths[i]), height - 1,
                           prefix + keys[i][:common[i]], out)
            return
        lengths = c.varints(n)
        kinds = c.varints(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k not in (0, 1) for k in kinds):
            raise ValueError(f"{where}: unknown value kind in {sorted(set(kinds))}")
        ids, offsets = c.varints(len(indirect)), c.varints(len(indirect))
        where_of = dict(zip(indirect, zip(ids, offsets)))
        for i in range(n):
            if kinds[i] == 0:
                value = c.take(lengths[i])
            else:
                fid, off = where_of[i]
                value = self.read_at((files[fid], off, lengths[i]))
            out[prefix + keys[i]] = value
        c.end()


# -- zarr v2 ------------------------------------------------------------------

#: zarr v2 dtype strings read and written; ``bfloat16`` is stored as its bits
ZARR_DTYPES = {"<f4": np.float32, "<f8": np.float64, "<i4": np.int32, "<i8": np.int64,
               "|u1": np.uint8, "|b1": np.bool_, "bfloat16": np.uint16}


def read_zarr_array(get: Callable[[str], bytes | None], name: str):
    """The zarr v2 array ``name``: ``get(key)`` returns the bytes of a key
    (``<name>/.zarray``, ``<name>/<chunk>``) or None.  A numpy array, or a
    ``torch.bfloat16`` tensor for ``bfloat16``; a missing chunk raises."""
    raw = get(f"{name}/.zarray")
    if raw is None:
        raise KeyError(f"{name}: no .zarray")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')}, expected 2")
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise ValueError(f"{name}: order {meta.get('order')} with filters "
                         f"{meta.get('filters')} (only C order, no filters)")
    sep = meta.get("dimension_separator", ".")
    if sep != ".":
        raise ValueError(f"{name}: dimension_separator {sep!r} (only '.')")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {compressor} (only zstd or none)")
    dtype_str = meta["dtype"]
    if dtype_str not in ZARR_DTYPES:
        raise ValueError(f"{name}: dtype {dtype_str!r} not read")
    dtype = np.dtype(ZARR_DTYPES[dtype_str])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise ValueError(f"{name}: chunks {chunks} for shape {shape}")
    out = np.empty(shape, dtype)
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        key = f"{name}/{'.'.join(map(str, idx)) if idx else '0'}"
        data = get(key)
        if data is None:
            raise KeyError(f"{name}: chunk {key} is missing")
        if compressor is not None:
            data = zstd_decompress(data, chunk_bytes)
        if len(data) != chunk_bytes:
            raise ValueError(f"{key}: {len(data)} bytes, a chunk of {chunks} {dtype_str} is "
                             f"{chunk_bytes}")
        chunk = np.frombuffer(data, dtype).reshape(chunks)
        sel = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[sel] = chunk[tuple(slice(0, s.stop - s.start) for s in sel)]
    if dtype_str == "bfloat16":
        return torch.from_numpy(out).view(torch.bfloat16)
    return out


def _key_getter(path: str, use_ocdbt: bool) -> Callable[[str], bytes | None]:
    if use_ocdbt:
        items = OcdbtReader(path).items()
        return lambda key: items.get(key.encode())

    def get(key: str) -> bytes | None:
        try:
            with open(os.path.join(path, *key.split("/")), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    return get


def read_tree(path: str) -> dict:
    """The tree an orbax ``StandardCheckpointHandler`` directory holds, as
    orbax restores it without a target: dicts, lists for sequences, the
    empty values as they were, arrays as numpy (``bfloat16`` as
    ``torch.bfloat16`` tensors), ``scalar`` leaves as Python numbers."""
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    get = _key_getter(path, bool(meta.get("use_ocdbt", True)))
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: zarr v3 arrays are not read")
    root: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
        value_type = entry["value_metadata"]["value_type"]
        if value_type in EMPTY_VALUES:
            empty = EMPTY_VALUES[value_type]
            value = empty() if empty is not None else None
        else:
            value = read_zarr_array(get, ".".join(k for k, _ in keys))
            if value_type == "scalar":
                value = value.item()
            elif value_type not in ("np.ndarray", "jax.Array"):
                raise ValueError(f"{path}: leaf {keys} of value_type {value_type!r} not read")
        node = root
        for (key, _), (_, child_type) in zip(keys, keys[1:]):
            node = node.setdefault(key, {"__seq__": True} if child_type == KEY_SEQUENCE else {})
        node[keys[-1][0]] = value
    return _sequences(root)


def _sequences(node):
    """Dicts built for sequence keys become lists, in index order."""
    if not isinstance(node, dict):
        return node
    if node.pop("__seq__", False):
        idx = sorted(node, key=int)
        if [int(i) for i in idx] != list(range(len(idx))):
            raise ValueError(f"sequence indices {idx} are not 0..{len(idx) - 1}")
        return [_sequences(node[i]) for i in idx]
    return {k: _sequences(v) for k, v in node.items()}


def load_checkpoint_orbax(path: str) -> dict[str, Any]:
    """An orbax checkpoint directory as the ``.ckpt`` payload dict."""
    from tsdiff_tpu_torch.train.checkpoint import CKPT_FORMAT

    path = os.path.abspath(path)
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"unknown orbax checkpoint format {meta.get('format')!r} in {path}")
    wait_for_saves()
    tree = read_tree(path)
    return {
        "format": CKPT_FORMAT,
        "config": meta["config"],
        "params": tree["params"],
        "opt_state": tree.get("opt_state"),
        "ema_params": tree.get("ema_params"),
        "scheduler": meta.get("scheduler"),
        "iteration": meta.get("iteration", 0),
        "avg_val_loss": meta.get("avg_val_loss"),
    }


# -- writer -------------------------------------------------------------------

def _array_bytes(value) -> tuple[str, tuple, np.ndarray, str]:
    """``(zarr dtype, shape, data, value_type)`` of a leaf (a numpy array or
    scalar, a torch tensor, or a Python number): ``data`` a flat C-order
    little-endian array, written through its buffer without a copy to
    ``bytes``."""
    value_type = "np.ndarray"
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", tuple(t.shape), t.view(torch.int16).numpy().reshape(-1), value_type
        value = t.numpy()
    elif isinstance(value, (bool, int, float)) and not isinstance(value, np.generic):
        value_type = "scalar"
        value = np.asarray(value, np.bool_ if isinstance(value, bool)
                           else np.int64 if isinstance(value, int) else np.float64)
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":   # ml_dtypes' numpy bfloat16
        arr = arr.view(np.uint16)
        return "bfloat16", arr.shape, np.ascontiguousarray(arr, "<u2").reshape(-1), value_type
    dtype = arr.dtype.newbyteorder("<") if arr.dtype.itemsize > 1 else arr.dtype
    zarr = dtype.str
    if zarr not in ZARR_DTYPES or zarr == "bfloat16":
        raise ValueError(f"dtype {arr.dtype} is not written")
    return zarr, arr.shape, np.ascontiguousarray(arr, dtype).reshape(-1), value_type


def _flatten(tree, keys=()):
    """``(keys with their types, leaf)`` in orbax's order: dict keys sorted,
    sequences in order; empty containers and None are leaves."""
    if isinstance(tree, dict) and tree:
        for k in sorted(tree):
            yield from _flatten(tree[k], keys + ((str(k), KEY_DICT),))
    elif isinstance(tree, (list, tuple)) and tree:
        for i, v in enumerate(tree):
            yield from _flatten(v, keys + ((str(i), KEY_SEQUENCE),))
    else:
        yield keys, tree


def write_tree(path: str, tree: dict) -> None:
    """Write ``tree`` at ``path`` (which must not exist) as orbax's
    ``StandardCheckpointHandler`` does with ``use_ocdbt=False``, every array
    one uncompressed chunk."""
    t0 = time.time_ns()
    os.makedirs(path)
    tree_metadata = {}
    for keys, leaf in _flatten(tree):
        names = [k for k, _ in keys]
        key_metadata = [{"key": k, "key_type": t} for k, t in keys]
        empty = next((name for name, kind in EMPTY_VALUES.items() if kind is not None
                      and isinstance(leaf, kind) and not leaf), None)
        if leaf is None or empty is not None:
            value_metadata = {"value_type": empty or "None", "skip_deserialize": True}
        else:
            zarr, shape, data, value_type = _array_bytes(leaf)
            if any(s == 0 for s in shape):
                raise ValueError(f"{'.'.join(names)}: orbax does not save arrays of size 0")
            leaf_dir = os.path.join(path, ".".join(names))
            os.makedirs(leaf_dir)
            zarray = {"chunks": list(shape), "compressor": None, "dimension_separator": ".",
                      "dtype": zarr, "fill_value": None, "filters": None, "order": "C",
                      "shape": list(shape), "zarr_format": 2}
            with open(os.path.join(leaf_dir, ".zarray"), "w") as f:
                json.dump(zarray, f, sort_keys=True, separators=(",", ":"))
            with open(os.path.join(leaf_dir, ".".join("0" * len(shape)) or "0"), "wb") as f:
                f.write(data)
            value_metadata = {"value_type": value_type, "skip_deserialize": False}
        tree_metadata[str(tuple(names))] = {"key_metadata": key_metadata,
                                            "value_metadata": value_metadata}
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree_metadata, "use_ocdbt": False, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
    with open(os.path.join(path, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": t0, "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)


def _meta(payload: dict) -> dict:
    return {"format": FORMAT, "config": payload["config"], "scheduler": payload.get("scheduler"),
            "iteration": int(payload.get("iteration") or 0),
            "avg_val_loss": payload.get("avg_val_loss"),
            "has_ema": payload.get("ema_params") is not None}


def _write_meta(path: str, meta: dict) -> None:
    tmp = path + ".meta.tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, path + ".meta.json")


def _write_tree_atomic(path: str, payload: dict) -> None:
    """The payload's tree written into a temporary sibling directory, then
    renamed to ``path`` (replacing a directory there)."""
    tree = {k: payload[k] for k in ("params", "opt_state", "ema_params")
            if payload.get(k) is not None}
    stamp = time.time_ns()
    tmp = f"{path}.orbax-checkpoint-tmp-{stamp}"
    try:
        write_tree(tmp, tree)
        if os.path.exists(path):
            old = f"{path}.orbax-checkpoint-old-{stamp}"
            os.replace(path, old)
            os.replace(tmp, path)
            shutil.rmtree(old)
        else:
            os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def write_checkpoint_orbax(path: str, payload: dict) -> None:
    """Write a checkpoint payload (the dict ``load_checkpoint`` returns, an
    ``opt_state`` or ``ema_params`` of None left out) as the orbax directory
    ``path`` and its meta file, synchronously."""
    path = os.path.abspath(path)
    _write_meta(path, _meta(payload))
    _write_tree_atomic(path, payload)


class _Snapshot:
    """Copies of a train state's tensors, taken when the save is called.
    Tensors on the card are cloned on the current stream (so a later step,
    eager or replayed, cannot change them), then copied into pinned host
    memory on a side stream; ``state()`` waits for that copy."""

    def __init__(self, state, streams: dict):
        tensors = {("param", k): v for k, v in state.params.items()}
        opt = state.opt_state
        for part in ("mu", "nu"):
            tensors.update({(part, k): v for k, v in opt[part].items()})
        if state.ema_params is not None:
            tensors.update({("ema", k): v for k, v in state.ema_params.items()})
        tensors[("count",)] = opt["count"]
        tensors[("step",)] = state.step
        self.has_ema = state.ema_params is not None
        self.event = None
        self.host = {}
        on_card = {k: v for k, v in tensors.items()
                   if isinstance(v, torch.Tensor) and v.device.type == "cuda"}
        for k, v in tensors.items():
            if k not in on_card:
                self.host[k] = v.detach().clone() if isinstance(v, torch.Tensor) else v
        if on_card:
            device = next(iter(on_card.values())).device
            current = torch.cuda.current_stream(device)
            side = streams.setdefault(device, torch.cuda.Stream(device))
            clones = {k: v.detach().clone() for k, v in on_card.items()}
            side.wait_stream(current)
            with torch.cuda.stream(side):
                for k, c in clones.items():
                    self.host[k] = torch.empty(c.shape, dtype=c.dtype, pin_memory=True)
                    self.host[k].copy_(c, non_blocking=True)
                    c.record_stream(side)
            self.event = torch.cuda.Event()
            self.event.record(side)

    def state(self):
        from tsdiff_tpu_torch.train.trainer import TrainState

        if self.event is not None:
            self.event.synchronize()
        h = self.host
        part = {p: {k[1]: v for k, v in h.items() if k[0] == p} for p in ("param", "mu", "nu",
                                                                          "ema")}
        return TrainState(part["param"], {"count": h[("count",)], "mu": part["mu"],
                                          "nu": part["nu"]},
                          h[("step",)], part["ema"] if self.has_ema else None)


class OrbaxWriter:
    """Asynchronous orbax checkpoint saves, written in order by one thread."""

    def __init__(self):
        self._pool: ThreadPoolExecutor | None = None
        self._pending: list[Future] = []
        self._streams: dict = {}
        self._lock = threading.Lock()
        #: per finished save: (path, seconds from the save call to its rename)
        self.finished: list[tuple[str, float]] = []

    def save(self, path: str, config, state, scheduler_state: dict | None = None,
             iteration: int | None = None, avg_val_loss: float | None = None) -> None:
        """Snapshot ``state`` (a ``train.trainer.TrainState``), write the meta
        file, and queue the tree's write; returns before the tree is written.
        A failed earlier write raises here."""
        self._raise_failed(done_only=True)
        t0 = time.monotonic()
        path = os.path.abspath(path)
        cfg = config.to_dict() if hasattr(config, "to_dict") else dict(config)
        snap = _Snapshot(state, self._streams)
        iteration = int(iteration if iteration is not None else state.step)
        # written now, as the JAX package writes it; the directory follows
        _write_meta(path, _meta({"config": cfg, "scheduler": scheduler_state,
                                 "iteration": iteration, "avg_val_loss": avg_val_loss,
                                 "ema_params": state.ema_params}))
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=1,
                                                thread_name_prefix="orbax-checkpoint")
            self._pending.append(self._pool.submit(self._write, path, cfg, snap, scheduler_state,
                                                   iteration, avg_val_loss, t0))

    def _write(self, path, cfg, snap, scheduler_state, iteration, avg_val_loss, t0) -> None:
        from tsdiff_tpu_torch.train.checkpoint import checkpoint_payload

        _write_tree_atomic(path, checkpoint_payload(cfg, snap.state(), scheduler_state,
                                                    iteration, avg_val_loss))
        self.finished.append((path, time.monotonic() - t0))

    def _raise_failed(self, done_only: bool) -> None:
        with self._lock:
            pending = self._pending
            if done_only:
                pending = [f for f in pending if f.done()]
            self._pending = [f for f in self._pending if f not in pending]
        errors = [f.exception() for f in pending]
        for e in errors:
            if e is not None:
                raise e

    def wait(self) -> None:
        """Barrier on every queued write; raises the first write's exception."""
        self._raise_failed(done_only=False)


_default_writer: OrbaxWriter | None = None


def default_writer() -> OrbaxWriter:
    global _default_writer
    if _default_writer is None:
        _default_writer = OrbaxWriter()
    return _default_writer


def save_checkpoint_orbax(path: str, config, state, scheduler_state: dict | None = None,
                          iteration: int | None = None, avg_val_loss: float | None = None) -> None:
    """Asynchronous save of ``state`` as the orbax directory ``path``
    (conventionally ``<iter>.orbax``); returns once the state is copied.
    Call :func:`wait_for_saves` before the process exits."""
    default_writer().save(path, config, state, scheduler_state, iteration, avg_val_loss)


def wait_for_saves() -> None:
    """Barrier on all outstanding checkpoint writes; raises what a write raised."""
    if _default_writer is not None:
        _default_writer.wait()
