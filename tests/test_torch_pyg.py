"""Reference PyG pickles in the port against the JAX package.

The reference stores datasets and ``samples_all.pkl`` as pickles of
``torch_geometric.data.Data`` (old style: fields in ``__dict__``; PyG >= 2:
in a ``_store``), often with RDKit objects inside.  Neither package is
installed here: the port's ``load_dataset`` unpickles them through the
stand-ins of ``data/pyg_compat.py``, converts them in memory, and removes
the stand-ins.  Fixtures are written while the stand-ins are installed (they
pickle under the PyG and RDKit names), then the stand-ins are removed, so
loading takes the path a real reference pickle takes.
"""

import pickle
import sys

import numpy as np
import jax
import pytest
import torch

from tsdiff_tpu.cli import evaluate as jax_evaluate
from tsdiff_tpu.data.dataset import load_dataset as jax_load_dataset

from tsdiff_tpu_torch.cli import evaluate, sampling
from tsdiff_tpu_torch.data import pyg_compat
from tsdiff_tpu_torch.data.dataset import load_dataset, save_dataset
from tsdiff_tpu_torch.data.synthetic import make_corpus

from test_condensenc import MODEL_CFG
from test_torch_common import small_setup


def pyg_fields(g: dict) -> dict:
    """A numpy graph dict as the reference's Data fields (torch tensors,
    the condensed bonds as ``edge_index``/``edge_type``)."""
    row, col = np.nonzero(g["bond_mat"])
    fields = dict(
        atom_type=torch.from_numpy(np.asarray(g["atom_type"], np.int64)),
        r_feat=torch.from_numpy(np.asarray(g["r_feat"])),
        p_feat=torch.from_numpy(np.asarray(g["p_feat"])),
        pos=torch.from_numpy(np.asarray(g["pos"])),
        edge_index=torch.from_numpy(np.stack([row, col]).astype(np.int64)),
        edge_type=torch.from_numpy(g["bond_mat"][row, col].astype(np.int64)),
        smiles=g.get("smiles"),
    )
    for key in ("ts_guess", "pos_gen"):
        if key in g:
            fields[key] = torch.from_numpy(np.asarray(g[key]))
    return fields


def write_pyg_pickle(path: str, graphs: list[dict], style: str = "old") -> None:
    """Write ``graphs`` as a reference PyG pickle: ``style`` "old" (fields in
    ``__dict__``), "store" (PyG >= 2) or "rdkit" (old, with an RDKit
    molecule per Data)."""
    installed = pyg_compat.install_pyg_stubs()
    try:
        data_list = []
        for g in graphs:
            d = pyg_compat.StubData()
            fields = pyg_fields(g)
            if style == "store":
                store = pyg_compat.StubStorage()
                store._mapping = fields
                d._store = store
            else:
                d.__dict__.update(fields)
            if style == "rdkit":
                d.rdmol = sys.modules["rdkit.Chem.rdchem"].Mol(b"mol-blob")
            data_list.append(d)
        with open(path, "wb") as f:
            pickle.dump(data_list, f)
    finally:
        for name in installed:
            sys.modules.pop(name, None)


def no_stubs_left() -> bool:
    return not any(pyg_compat.is_stub(m) for m in list(sys.modules.values()))


@pytest.mark.parametrize("style", ["old", "store", "rdkit"])
def test_pyg_pickle_loads_as_jax(tmp_path, style):
    graphs = make_corpus(4, seed=5)
    for g in graphs[:2]:
        g["ts_guess"] = (g["pos"] + 0.1).astype(np.float32)
    path = str(tmp_path / "pyg.pkl")
    write_pyg_pickle(path, graphs, style)
    assert no_stubs_left() and "torch_geometric" not in sys.modules
    got, got_fd = load_dataset(path)
    assert no_stubs_left() and "torch_geometric" not in sys.modules
    want, want_fd = jax_load_dataset(path)
    assert got_fd is want_fd is None and len(got) == len(want) == 4
    for g, w, src in zip(got, want, graphs):
        assert set(g) == set(w)
        for k, v in g.items():
            if isinstance(v, np.ndarray):
                assert v.dtype == w[k].dtype, k
                np.testing.assert_array_equal(v, w[k], err_msg=k)
            else:
                assert v == w[k] == src[k], k
        np.testing.assert_array_equal(g["pos"], src["pos"])


def test_evaluate_cli_on_pyg_samples_prints_jax_numbers(tmp_path, capsys):
    rng = np.random.default_rng(8)
    graphs = make_corpus(6, seed=8)
    for g in graphs:
        g["pos_gen"] = (g["pos"] + rng.normal(scale=0.3, size=g["pos"].shape)).astype(np.float32)
    path = str(tmp_path / "samples_all.pkl")
    write_pyg_pickle(path, graphs)
    want = jax_evaluate.main(["--samples", path, "--out", str(tmp_path / "jax.pkl")])
    jax_printed = capsys.readouterr().out
    got = evaluate.main(["--samples", path, "--out", str(tmp_path / "port.pkl")])
    assert capsys.readouterr().out == jax_printed
    assert "6 samples evaluated" in jax_printed
    np.testing.assert_allclose(got["dmae"], want["dmae"], rtol=1e-12, atol=1e-12)


def test_sampling_cli_on_pyg_pickle_equals_native(tmp_path):
    """The same reactions from a PyG pickle and from a native pickle give
    the same samples, bit for bit."""
    _, params, _, _, _, graphs = small_setup(seed=7, sizes=(5, 9, 7), members=2)
    ckpts = []
    for m, p in enumerate(params):
        ckpts.append(str(tmp_path / f"m{m}.ckpt"))
        with open(ckpts[-1], "wb") as f:
            pickle.dump({"format": "tsdiff_tpu.ckpt.v1", "config": {"model": MODEL_CFG.to_dict()},
                         "params": jax.device_get(p), "ema_params": None}, f)
    for i, g in enumerate(graphs):
        g["smiles"] = f"g{i}"
    native, pyg = str(tmp_path / "native.pkl"), str(tmp_path / "pyg.pkl")
    save_dataset(native, graphs)
    write_pyg_pickle(pyg, graphs)
    out = {}
    for name, test_set in (("native", native), ("pyg", pyg)):
        path = sampling.main(ckpts + ["--test_set", test_set, "--save_dir", str(tmp_path / name),
                                      "--n_steps", "6", "--batch_size", "2", "--device", "cpu",
                                      "--fused_score"])
        with open(path, "rb") as f:
            out[name] = pickle.load(f)
    assert [r["smiles"] for r in out["pyg"]] == [r["smiles"] for r in out["native"]]
    for a, b in zip(out["pyg"], out["native"]):
        np.testing.assert_array_equal(a["pos_gen"], b["pos_gen"])
        assert np.isfinite(a["pos_gen"]).all()


def test_uninstall_removes_only_the_stubs(monkeypatch):
    """``torch.ops`` and ``torch.classes`` answer any attribute, the stub
    mark included: they must stay in ``sys.modules``.  The test puts them
    there itself: another test may have run the JAX package's
    ``uninstall_pyg_stubs``, which drops them."""
    monkeypatch.setitem(sys.modules, "torch.ops", torch.ops)
    monkeypatch.setitem(sys.modules, "torch.classes", torch.classes)
    assert getattr(sys.modules["torch.ops"], "__tsdiff_tpu_stub__", False)
    installed = pyg_compat.install_pyg_stubs()
    assert "torch_geometric" in installed
    removed = pyg_compat.uninstall_pyg_stubs()
    assert sorted(removed) == sorted(installed)
    assert "torch.ops" in sys.modules and "torch.classes" in sys.modules and no_stubs_left()
