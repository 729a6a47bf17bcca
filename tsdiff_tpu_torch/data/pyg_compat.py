"""Unpickle reference PyG artifacts without torch_geometric or RDKit.

The reference persists datasets and sampling outputs as plain pickles of
``torch_geometric.data.Data`` lists (its sampling.py writes
``samples_all.pkl``; its utils/datasets.py builds the dataset pickles), often
with embedded ``rdkit.Chem.rdchem.Mol`` objects and rdkit enum values
(``feat_dict.pkl``).  Only the tensors matter here, so this module installs
minimal stand-in modules into ``sys.modules`` (only for names that do not
import) and lets ``pickle.load`` materialize the graph tensors through them.

The stand-ins carry the mark ``__tsdiff_tpu_stub__``, the JAX package's own:
a process that holds both packages never takes either's stub ``rdkit`` for
the real one.  The tensors in such a pickle deserialize through
``torch.storage``; the stubs never touch a device.
"""

from __future__ import annotations

import pickle
import sys
import types

_STUB_MARK = "__tsdiff_tpu_stub__"


class StubData:
    """Attribute-bag stand-in for ``torch_geometric.data.Data``.

    Old-style PyG (<2.0) pickles Data via the default object protocol —
    class lookup + ``__dict__`` state — so no methods are needed; fields
    appear as plain attributes.  New-style (>=2.0) Data keeps fields in a
    ``_store`` storage object; see :func:`data_attrs`.

    ``__module__``/``__qualname__`` claim the PyG identity so instances
    also PICKLE as ``torch_geometric.data.data.Data`` (works only while the
    stubs are installed) — test fixtures written this way exercise the
    exact global-resolution path real reference pickles take.
    """

    __module__ = "torch_geometric.data.data"
    __qualname__ = "Data"

    def __init__(self, **kwargs):
        self.__dict__.update(kwargs)


class StubStorage:
    """Stand-in for ``torch_geometric.data.storage.*Storage`` (PyG >= 2.0)."""

    __module__ = "torch_geometric.data.storage"
    __qualname__ = "BaseStorage"

    def __setstate__(self, state):
        if isinstance(state, dict):
            # BaseStorage state: {'_mapping': {...}, '_parent': ...}
            self.__dict__.update(state)


class StubMol:
    """Stand-in for ``rdkit.Chem.rdchem.Mol`` — RDKit pickles molecules as
    ``Mol(binary_blob)``; the blob is kept verbatim so a later environment
    WITH rdkit could round-trip it, but nothing here interprets it."""

    __module__ = "rdkit.Chem.rdchem"
    __qualname__ = "Mol"

    def __init__(self, *args):
        self.pickle_args = args

    def __setstate__(self, state):
        self.pickle_state = state


_ENUM_CACHE: dict[str, type] = {}


def _stub_enum(name: str) -> type:
    """A hashable value-holder class for rdkit Boost enums (pickled as
    ``EnumName(int_value)``).  Cached per name so equality/hashing is stable
    across instances — feat_dict uses enum values as dict keys."""
    cls = _ENUM_CACHE.get(name)
    if cls is None:

        class _E:
            args: tuple = ()

            # Boost enums pickle as NEWOBJ — cls.__new__(cls, value) with
            # __init__ never called — so capture the args in __new__
            def __new__(cls, *args):
                self = object.__new__(cls)
                self.args = args
                return self

            def __init__(self, *args):
                self.args = args

            def __setstate__(self, state):
                self.args = state if isinstance(state, tuple) else (state,)

            @property
            def value(self):
                return self.args[0] if self.args else None

            def __repr__(self):
                return f"<stub {name}{self.args}>"

            def __eq__(self, other):
                return type(other) is type(self) and other.args == self.args

            def __hash__(self):
                return hash((name, self.args))

        _E.__name__ = name
        _E.__qualname__ = name
        cls = _ENUM_CACHE[name] = _E
    return cls


def install_pyg_stubs() -> list[str]:
    """Register stub modules for torch_geometric / rdkit, skipping any that
    already import for real.  Idempotent; returns the names installed."""
    installed: list[str] = []

    def put(name: str, mod: types.ModuleType):
        if name not in sys.modules:
            setattr(mod, _STUB_MARK, True)
            sys.modules[name] = mod
            installed.append(name)

    try:
        import torch_geometric  # noqa: F401
    except ImportError:
        tg = types.ModuleType("torch_geometric")
        tgd = types.ModuleType("torch_geometric.data")
        tgdd = types.ModuleType("torch_geometric.data.data")
        tgds = types.ModuleType("torch_geometric.data.storage")
        tgd.Data = tgdd.Data = StubData
        # PyG >= 2.4 registers these alongside Data in reduce payloads
        tgdd.DataEdgeAttr = _stub_enum("DataEdgeAttr")
        tgdd.DataTensorAttr = _stub_enum("DataTensorAttr")
        for s in ("BaseStorage", "NodeStorage", "EdgeStorage", "GlobalStorage"):
            setattr(tgds, s, StubStorage)
        tg.data = tgd
        tgd.data = tgdd
        tgd.storage = tgds
        put("torch_geometric", tg)
        put("torch_geometric.data", tgd)
        put("torch_geometric.data.data", tgdd)
        put("torch_geometric.data.storage", tgds)

    try:
        import rdkit  # noqa: F401
    except ImportError:
        rk = types.ModuleType("rdkit")
        rkc = types.ModuleType("rdkit.Chem")
        rkcr = types.ModuleType("rdkit.Chem.rdchem")
        rkg = types.ModuleType("rdkit.Geometry")

        def _enum_module_getattr(name: str):  # PEP 562 module __getattr__
            if name == "Mol":
                return StubMol
            if name.startswith("__"):
                # other tooling (inspect, pickle introspection) probes
                # modules for dunders like __file__ — must raise, not stub
                raise AttributeError(name)
            return _stub_enum(name)

        rkcr.__getattr__ = _enum_module_getattr
        rkg.__getattr__ = _enum_module_getattr  # Point3D etc.
        rkc.Mol = StubMol
        rkc.rdchem = rkcr
        rk.Chem = rkc
        rk.Geometry = rkg
        put("rdkit", rk)
        put("rdkit.Chem", rkc)
        put("rdkit.Chem.rdchem", rkcr)
        put("rdkit.Geometry", rkg)

    return installed


def is_stub(module) -> bool:
    """A stand-in module of this file or of the JAX package's twin: its own
    ``__dict__`` holds the mark, set to True.  (``torch.ops`` and
    ``torch.classes`` answer any attribute, and keep what they answered.)"""
    return getattr(module, "__dict__", {}).get(_STUB_MARK) is True


def uninstall_pyg_stubs() -> list[str]:
    """Remove every stub module this file installed (identified by the
    ``__tsdiff_tpu_stub__`` mark).  Objects already unpickled keep working —
    their classes hold direct references; only the ``sys.modules`` entries
    go, so availability probes (``import rdkit`` / ``import
    torch_geometric``) fail again as they should.  Returns the removed
    names."""
    removed = [name for name, mod in list(sys.modules.items()) if is_stub(mod)]
    for name in removed:
        del sys.modules[name]
    return removed


def data_attrs(d) -> dict:
    """Field dict of a (stub or real) Data object — handles old-style
    ``__dict__`` fields and new-style ``_store`` storages uniformly."""
    out = {
        k: v for k, v in getattr(d, "__dict__", {}).items()
        if not k.startswith("_") and v is not None
    }
    store = getattr(d, "_store", None)
    if store is not None:
        mapping = getattr(store, "_mapping", None) or {
            k: v for k, v in getattr(store, "__dict__", {}).items()
            if not k.startswith("_")
        }
        out.update({k: v for k, v in mapping.items() if v is not None})
    return out


def load_pyg_pickle(path: str):
    """``pickle.load`` a reference PyG artifact with the stubs installed.

    Returns whatever the pickle holds (usually a list of Data).  torch is
    imported before the stubs go in: its import machinery walks
    ``sys.modules`` and must not meet half-built stand-ins."""
    import torch  # noqa: F401

    installed = install_pyg_stubs()
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    finally:
        # never leave fake modules behind: a lingering stub would flip
        # availability probes (chem.have_rdkit and friends) process-wide.
        # Only remove what THIS call installed — a caller managing stubs
        # explicitly (install_pyg_stubs before us) keeps its own.
        for name in installed:
            sys.modules.pop(name, None)
