"""Reader of PyTorch ``.pt`` checkpoint files that runs no pickled code.

Reference checkpoints (``<iter>.pt``, ``best_ckpt.pt``) are zip archives in
the torch>=1.6 serialization format:

    <name>/data.pkl       pickle of the checkpoint dict; tensors appear as
                          ``torch._utils._rebuild_tensor_v2(storage, offset,
                          size, stride, requires_grad, hooks)`` calls whose
                          storages are pickle persistent IDs
                          ``('storage', <StorageClass>, key, location, numel)``
    <name>/data/<key>     raw little-endian element buffers, one per storage
    <name>/byteorder      'little' | 'big' (optional; little assumed)

Every tensor is materialized as a numpy array with only the standard
library's ``zipfile`` and a restricted ``pickle.Unpickler``.  ``torch.load``
is not used: with ``weights_only=True`` (torch >= 2.6's default) it rejects
the reference's ``EasyDict`` config, and with ``weights_only=False`` it runs
whatever constructors a downloaded file names.  Only the globals listed in
``_SAFE_GLOBALS`` and the storage classes are honored; anything else
unpickles to an inert placeholder.
"""

from __future__ import annotations

import io
import pickle
import zipfile

import numpy as np

# torch storage class name -> numpy dtype of the raw buffer
_STORAGE_DTYPES = {
    "DoubleStorage": np.dtype("<f8"),
    "FloatStorage": np.dtype("<f4"),
    "HalfStorage": np.dtype("<f2"),
    "BFloat16Storage": np.dtype("<u2"),  # bit pattern; widened to f32 below
    "LongStorage": np.dtype("<i8"),
    "IntStorage": np.dtype("<i4"),
    "ShortStorage": np.dtype("<i2"),
    "CharStorage": np.dtype("<i1"),
    "ByteStorage": np.dtype("<u1"),
    "BoolStorage": np.dtype("?"),
    "ComplexFloatStorage": np.dtype("<c8"),
    "ComplexDoubleStorage": np.dtype("<c16"),
}

_BF16 = {"BFloat16Storage"}


class _Storage:
    """A lazily-read storage: dtype + flat numpy buffer."""

    def __init__(self, data: np.ndarray, is_bf16: bool):
        self.data = data
        self.is_bf16 = is_bf16


def _rebuild_tensor_v2(storage, storage_offset, size, stride, *unused):
    """numpy stand-in for torch._utils._rebuild_tensor_v2."""
    flat = storage.data
    itemsize = flat.dtype.itemsize
    strides = tuple(s * itemsize for s in stride)
    arr = np.lib.stride_tricks.as_strided(
        flat[storage_offset:], shape=tuple(size), strides=strides
    ).copy()
    if storage.is_bf16:
        # widen bf16 bit patterns to float32: bits << 16
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return arr


def _rebuild_from_type_v2(func, new_type, args, state):
    # wraps plain-tensor rebuilds for tensor subclasses (e.g. Parameter)
    return func(*args)


class _Placeholder:
    """Inert stand-in for unknown globals (scheduler/optimizer internals)."""

    def __init__(self, module: str, name: str):
        self._qualname = f"{module}.{name}"

    def __call__(self, *a, **k):
        return self

    def __setstate__(self, state):
        self._state = state

    def __repr__(self):  # pragma: no cover
        return f"<placeholder {self._qualname}>"


def _placeholder_factory(module: str, name: str):
    # a fresh subclass per global so REDUCE/NEWOBJ both work
    return type(name, (_Placeholder,), {"__init__": lambda self, *a, **k: None,
                                        "_qualname": f"{module}.{name}"})


_SAFE_GLOBALS = {
    ("torch._utils", "_rebuild_tensor_v2"): _rebuild_tensor_v2,
    ("torch._utils", "_rebuild_parameter"): lambda t, *a: t,
    ("torch._tensor", "_rebuild_from_type_v2"): _rebuild_from_type_v2,
    ("collections", "OrderedDict"): dict,
    ("easydict", "EasyDict"): dict,  # reference configs (train.py:46-47)
    ("argparse", "Namespace"): _placeholder_factory("argparse", "Namespace"),
}


class _TorchUnpickler(pickle.Unpickler):
    def __init__(self, file, storages: dict):
        super().__init__(file)
        self._storages = storages

    def find_class(self, module, name):
        if (module, name) in _SAFE_GLOBALS:
            return _SAFE_GLOBALS[(module, name)]
        if module == "torch" and name in _STORAGE_DTYPES:
            return name  # storage classes only ever appear inside persid tuples
        if module == "torch" and name == "UntypedStorage":
            return name
        # torch.float32 etc. appear in optimizer/scheduler states
        return _placeholder_factory(module, name)

    def persistent_load(self, pid):
        kind, storage_cls, key, _location, _numel = pid
        assert kind == "storage", f"unknown persistent id {pid!r}"
        name = storage_cls if isinstance(storage_cls, str) else storage_cls.__name__
        raw, dtype_hint = self._storages[key]
        dtype = _STORAGE_DTYPES.get(name, dtype_hint)
        if dtype is None:
            raise ValueError(f"cannot infer dtype for storage class {name}")
        return _Storage(np.frombuffer(raw, dtype=dtype), is_bf16=name in _BF16)


def load_torch_file(path: str):
    """Read a torch>=1.6 zip-format ``.pt`` file without torch.

    Tensors become numpy arrays (bf16 widened to float32); unknown classes
    become inert placeholders.  Raises ``ValueError`` on the pre-1.6 legacy
    tar format.
    """
    if not zipfile.is_zipfile(path):
        raise ValueError(
            f"{path}: not a zip-format torch checkpoint (legacy torch<1.6 "
            "format is not supported; re-save with a modern torch)"
        )
    with zipfile.ZipFile(path) as z:
        names = z.namelist()
        pkl_name = next((n for n in names if n.endswith("/data.pkl")), None)
        if pkl_name is None:
            raise ValueError(
                f"{path}: zip archive contains no */data.pkl — not a torch checkpoint"
            )
        prefix = pkl_name[: -len("data.pkl")]
        byteorder_name = f"{prefix}byteorder"
        if byteorder_name in names and z.read(byteorder_name).strip() == b"big":
            raise ValueError(f"{path}: big-endian checkpoints are not supported")
        storages = {
            n[len(prefix) + len("data/"):]: (z.read(n), None)
            for n in names
            if n.startswith(f"{prefix}data/")
        }
        return _TorchUnpickler(io.BytesIO(z.read(pkl_name)), storages).load()
