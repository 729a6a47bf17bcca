"""Featurization, splits, xyz files and the dataset-build CLIs of the port
against the JAX package.

RDKit is absent here, so molecules are duck-typed mocks (as in
``tests/test_featurize_mock.py``) and SMARTS strings reach them through a
fake ``rdkit.Chem`` whose ``MolFromSmarts`` looks the string up in a table;
it is installed in ``sys.modules`` for both packages alike.  Everything here
is numpy on the host: equal means equal, bit for bit.
"""

import csv
import os
import pickle
import random
import sys
import types

import numpy as np
import pytest
import torch

from tsdiff_tpu.cli import post_processing as jax_post
from tsdiff_tpu.cli import preprocessing as jax_pre
from tsdiff_tpu.data import featurize as jfeat
from tsdiff_tpu.data import parse_xyz as jxyz
from tsdiff_tpu.data import splits as jsplits

from tsdiff_tpu_torch.cli import post_processing, preprocessing, sampling
from tsdiff_tpu_torch.config import Config
from tsdiff_tpu_torch.convert import params_to_jax
from tsdiff_tpu_torch.data import featurize, parse_xyz, splits
from tsdiff_tpu_torch.data.dataset import save_dataset
from tsdiff_tpu_torch.models import CondenseEncoderEpsNetwork

from test_condensenc import MODEL_CFG
from test_featurize_mock import MockBond, _reaction

#: the values each atom getter takes in the mock molecules (a full vocabulary)
VOCAB = {
    "GetIsAromatic": (False, True), "GetFormalCharge": (0, 1), "GetHybridization": (3, 4),
    "GetTotalNumHs": (0, 1, 2), "GetTotalValence": (1, 4), "GetTotalDegree": (1, 2, 3, 4),
    "GetChiralTag": (0,), "IsInRing": (False, True),
}
assert tuple(VOCAB) == jfeat.DEFAULT_FEATURES == featurize.DEFAULT_FEATURES
ELEMENTS = (1, 6, 7, 8)


class Atom:
    def __init__(self, map_num: int, z: int, features: dict):
        self.map_num, self.z = map_num, z
        for name, value in features.items():
            setattr(self, name, lambda v=value: v)

    def GetAtomMapNum(self):
        return self.map_num

    def GetAtomicNum(self):
        return self.z


class Mol:
    def __init__(self, atoms, bonds):
        self.atoms, self.bonds = atoms, bonds

    def GetNumAtoms(self):
        return len(self.atoms)

    def GetAtoms(self):
        return list(self.atoms)

    def GetBonds(self):
        return list(self.bonds)

    def GetBondBetweenAtoms(self, i, j):
        for b in self.bonds:
            if {b.GetBeginAtomIdx(), b.GetEndAtomIdx()} == {i, j}:
                return b
        return None


def random_reaction(rng: np.random.Generator, n: int):
    """``(R, P, z, pos)``: two mock molecules over the same mapped atoms in
    different atom orders, each with its own bonds and features."""
    z = rng.choice(ELEMENTS, size=n)

    def mol():
        order = rng.permutation(n) + 1
        atoms = [Atom(int(m), int(z[m - 1]),
                      {k: v[int(rng.integers(len(v)))] for k, v in VOCAB.items()})
                 for m in order]
        idx = {int(m): i for i, m in enumerate(order)}
        pairs = {(a, b) for a, b in rng.integers(1, n + 1, size=(n + 2, 2)) if a < b}
        bonds = [MockBond(idx[int(a)], idx[int(b)], int(rng.choice([1, 2, 3, 12])))
                 for a, b in sorted(pairs)]
        return Mol(atoms, bonds)

    return mol(), mol(), z, rng.normal(scale=1.5, size=(n, 3))


def make_reactions(count: int, seed: int) -> dict:
    """``{name: (R, P, z, pos)}`` of ``count`` random reactions."""
    rng = np.random.default_rng(seed)
    return {f"rxn{k}": random_reaction(rng, int(rng.integers(4, 9))) for k in range(count)}


@pytest.fixture
def fake_rdkit(monkeypatch):
    """A fake ``rdkit`` whose ``Chem.MolFromSmarts`` returns the mock
    molecule registered under the string; yields the registry."""
    table = {}
    chem = types.ModuleType("rdkit.Chem")
    chem.MolFromSmarts = lambda s: table[s]
    chem.SanitizeMol = lambda m: None
    rdkit = types.ModuleType("rdkit")
    rdkit.Chem = chem
    monkeypatch.setitem(sys.modules, "rdkit", rdkit)
    monkeypatch.setitem(sys.modules, "rdkit.Chem", chem)
    return table


def register(table: dict, reactions: dict) -> list[str]:
    """Register each reaction's molecules; its forward and reverse SMARTS."""
    smarts = []
    for name, (r, p, _, _) in reactions.items():
        table[f"{name}_r"], table[f"{name}_p"] = r, p
        smarts += [f"{name}_r>>{name}_p", f"{name}_p>>{name}_r"]
    return smarts


def assert_graphs_equal(got: list[dict], want: list[dict]) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in g.items():
            if isinstance(v, np.ndarray):
                assert v.dtype == w[k].dtype, k
                np.testing.assert_array_equal(v, w[k], err_msg=k)
            else:
                assert v == w[k], k


@pytest.mark.parametrize("case", ["hand", "random0", "random1"])
def test_mock_molecules_give_jax_graphs(case):
    if case == "hand":
        reactions = [(*_reaction(), np.arange(12, dtype=np.float64).reshape(4, 3))]
        feat = {"GetIsAromatic": {}, "GetTotalNumHs": {}}
    else:
        reactions = [(r, p, pos) for r, p, _, pos in make_reactions(3, int(case[-1])).values()]
        feat = featurize.default_feat_dict()
    assert feat == {k: {} for k in feat}
    got_fd, want_fd = {k: {} for k in feat}, {k: {} for k in feat}
    got, want = [], []
    for r, p, pos in reactions:
        g, got_fd = featurize.generate_ts_data(r, p, pos, feat_dict=got_fd)
        w, want_fd = jfeat.generate_ts_data(r, p, pos, feat_dict=want_fd)
        got.append(g)
        want.append(w)
    assert got_fd == want_fd
    assert_graphs_equal(got, want)
    assert_graphs_equal(featurize.one_hot_features(got, got_fd),
                        jfeat.one_hot_features(want, want_fd))


@pytest.mark.parametrize("seed", [0, 42, 1234])
@pytest.mark.parametrize("fn", ["index_split", "random_split"])
def test_splits_match_jax(fn, seed):
    args = (37,) if fn == "index_split" else (list(range(37)),)
    got = getattr(splits, fn)(*args, train=0.7, valid=0.2, seed=seed)
    random.seed(999)   # the global generator is reseeded, not read
    want = getattr(jsplits, fn)(*args, train=0.7, valid=0.2, seed=seed)
    assert [list(x) for x in got] == [list(x) for x in want]
    assert sorted(i for part in got for i in part) == list(range(74 if fn == "index_split" else 37))


def test_xyz_round_trip_equals_jax(tmp_path):
    reactions = make_reactions(4, seed=3)
    blocks = [parse_xyz.format_xyz_block(z, pos, comment=f"ts {k}")
              for k, (_, _, z, pos) in enumerate(reactions.values())]
    assert blocks == [jxyz.format_xyz_block(z, pos, comment=f"ts {k}")
                      for k, (_, _, z, pos) in enumerate(reactions.values())]
    corpus = tmp_path / "corpus.xyz"
    corpus.write_text("\n".join(blocks))
    got, want = parse_xyz.parse_xyz_corpus(str(corpus)), jxyz.parse_xyz_corpus(str(corpus))
    assert got == want and len(got) == 4
    for block, (_, _, z, pos) in zip(got, reactions.values()):
        (gs, gp), (ws, wp) = parse_xyz.read_xyz_block(block), jxyz.read_xyz_block(block)
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gp, wp)
        assert [parse_xyz.ATOMIC_NUMBERS[s] for s in gs] == list(z)
        np.testing.assert_allclose(gp, pos, atol=5e-9)


def write_corpus(tmp_path, table: dict, reactions: dict) -> tuple[str, str]:
    """The wb97xd3 layout: a TS xyz corpus and a CSV of atom-mapped
    forward/reverse SMARTS, reaction k at rows 2k and 2k + 1."""
    smarts = register(table, reactions)
    xyz = tmp_path / "ts.xyz"
    xyz.write_text("".join(parse_xyz.format_xyz_block(z, pos) for _, _, z, pos in
                           reactions.values() for _ in range(2)))
    csv_path = tmp_path / "rxn.csv"
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["idx", "AAM"])
        w.writeheader()
        w.writerows({"idx": i, "AAM": s} for i, s in enumerate(smarts))
    return str(xyz), str(csv_path)


def load(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def read_pickles(directory: str) -> dict:
    return {name: load(os.path.join(directory, name)) for name in sorted(os.listdir(directory))}


def test_preprocessing_cli_writes_jax_files(tmp_path, fake_rdkit, capsys):
    xyz, csv_path = write_corpus(tmp_path, fake_rdkit, make_reactions(10, seed=4))
    argv = ["--ts_data", xyz, "--rxn_smarts_file", csv_path, "--feat_dict",
            str(tmp_path / "absent.pkl"), "--ban_index", "2", "3", "--seed", "7"]
    jax_pre.main(argv + ["--save_dir", str(tmp_path / "jax")])
    jax_printed = capsys.readouterr().out
    preprocessing.main(argv + ["--save_dir", str(tmp_path / "port")])
    assert capsys.readouterr().out == jax_printed.replace(str(tmp_path / "jax"),
                                                          str(tmp_path / "port"))
    got, want = read_pickles(str(tmp_path / "port")), read_pickles(str(tmp_path / "jax"))
    assert sorted(got) == sorted(want) == ["feat_dict.pkl", "index_dict.pkl", "test_data.pkl",
                                           "train_data.pkl", "valid_data.pkl"]
    assert got["feat_dict.pkl"] == want["feat_dict.pkl"]
    assert got["index_dict.pkl"] == want["index_dict.pkl"]
    assert not {2, 3} & {i for ix in got["index_dict.pkl"].values() for i in ix}
    for name in ("train_data.pkl", "valid_data.pkl", "test_data.pkl"):
        assert got[name]["feat_dict"] == want[name]["feat_dict"]
        assert_graphs_equal(got[name]["graphs"], want[name]["graphs"])
    assert sum(len(got[n]["graphs"]) for n in got if n.endswith("_data.pkl")) == 18


def test_preprocessing_pdb_branch_raises(tmp_path):
    """The ``--pdb_glob`` branch is ported (``tests/test_torch_pdb.py``); a
    glob that matches no file raises as the JAX CLI's does."""
    with pytest.raises(SystemExit, match="no PDB files match"):
        preprocessing.main(["--pdb_glob", str(tmp_path / "*.pdb")])


def test_post_processing_cli_writes_jax_files(tmp_path, capsys):
    rng = np.random.default_rng(6)
    reactions = make_reactions(5, seed=6)
    graphs = [dict(atom_type=np.asarray(z, np.int32),
                   r_feat=np.zeros((len(z), 4), np.float32),
                   p_feat=np.zeros((len(z), 4), np.float32),
                   pos=pos.astype(np.float32), bond_mat=np.zeros((len(z), len(z)), np.int64),
                   smiles=name) for name, (_, _, z, pos) in reactions.items()]
    data = str(tmp_path / "data.pkl")
    save_dataset(data, graphs, feat_dict={"GetIsAromatic": {False: 0}})
    xyz = tmp_path / "guess.xyz"
    xyz.write_text("".join(parse_xyz.format_xyz_block(g["atom_type"], g["pos"] + rng.normal(
        scale=0.3, size=g["pos"].shape)) for g in graphs))
    for key in ("ts_guess", "pos_r"):
        argv = ["--data", data, "--xyz", str(xyz), "--key", key]
        jax_post.main(argv + ["--out", str(tmp_path / "jax.pkl")])
        jax_printed = capsys.readouterr().out
        post_processing.main(argv + ["--out", str(tmp_path / "port.pkl")])
        assert capsys.readouterr().out == jax_printed.replace("jax.pkl", "port.pkl")
        got, want = (load(str(tmp_path / f"{side}.pkl")) for side in ("port", "jax"))
        assert got["feat_dict"] == want["feat_dict"]
        assert_graphs_equal(got["graphs"], want["graphs"])
        assert got["graphs"][0][key].shape == graphs[0]["pos"].shape


def tiny_checkpoint(path: str, feat_dim: int) -> None:
    cfg = {**MODEL_CFG.to_dict(), "feat_dim": feat_dim}
    model = CondenseEncoderEpsNetwork.from_config(Config(cfg),
                                                  generator=torch.Generator().manual_seed(0))
    with open(path, "wb") as f:
        pickle.dump({"format": "tsdiff_tpu.ckpt.v1", "config": {"model": cfg},
                     "params": params_to_jax(model.state_dict()), "ema_params": None}, f)


def test_sampling_txt_equals_prefeaturized_pickle(tmp_path, fake_rdkit):
    """The sampling CLI on a .txt of SMARTS with --feat_dict and on the same
    reactions featurized beforehand: the same samples, bit for bit."""
    smarts = register(fake_rdkit, make_reactions(3, seed=9))
    feat_dict = {k: {v: i for i, v in enumerate(vals)} for k, vals in VOCAB.items()}
    feat_dim = sum(len(v) for v in VOCAB.values())
    fd_path, txt = str(tmp_path / "feat_dict.pkl"), tmp_path / "test.txt"
    with open(fd_path, "wb") as f:
        pickle.dump(feat_dict, f)
    txt.write_text("\n".join(smarts) + "\n")
    pkl = str(tmp_path / "test.pkl")
    save_dataset(pkl, featurize.featurize_smarts_list(smarts, {k: dict(v) for k, v in
                                                               feat_dict.items()}))
    ckpt = str(tmp_path / "m.ckpt")
    tiny_checkpoint(ckpt, feat_dim)
    out = {}
    for name, test_set in (("txt", str(txt)), ("pkl", pkl)):
        path = sampling.main([ckpt, "--test_set", test_set, "--feat_dict", fd_path, "--save_dir",
                              str(tmp_path / name), "--n_steps", "6", "--batch_size", "4",
                              "--device", "cpu", "--fused_score"])
        with open(path, "rb") as f:
            out[name] = pickle.load(f)
    assert len(out["txt"]) == len(out["pkl"]) == 6
    for a, b in zip(out["txt"], out["pkl"]):
        assert a["smiles"] == b["smiles"] and a["r_feat"].shape[-1] == feat_dim
        np.testing.assert_array_equal(a["pos_gen"], b["pos_gen"])
    # one raw SMARTS string on the command line: the first reaction alone
    path = sampling.main([ckpt, "--test_set", smarts[0], "--feat_dict", fd_path, "--save_dir",
                          str(tmp_path / "raw"), "--n_steps", "6", "--batch_size", "4",
                          "--device", "cpu", "--fused_score"])
    with open(path, "rb") as f:
        (raw,) = pickle.load(f)
    assert raw["smiles"] == smarts[0] and np.isfinite(raw["pos_gen"]).all()


@pytest.mark.parametrize("test_set", ["test.txt", "rxn0_r>>rxn0_p"])
def test_smarts_test_sets_without_rdkit_raise_import_error(tmp_path, monkeypatch, test_set):
    ckpt = str(tmp_path / "m.ckpt")
    tiny_checkpoint(ckpt, 8)
    (tmp_path / "test.txt").write_text("rxn0_r>>rxn0_p\n")
    with open(tmp_path / "fd.pkl", "wb") as f:
        pickle.dump(featurize.default_feat_dict(), f)
    monkeypatch.setitem(sys.modules, "rdkit", None)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ImportError, match="RDKit is required"):
        sampling.main([ckpt, "--test_set", test_set, "--feat_dict", "fd.pkl", "--save_dir",
                       "out", "--device", "cpu", "--fused_score"])


def test_chem_matches_jax(monkeypatch):
    from tsdiff_tpu import chem as jchem
    from tsdiff_tpu_torch import chem
    from tsdiff_tpu_torch.data import pyg_compat

    assert chem.BOND_TYPES == jchem.BOND_TYPES and chem.NUM_BOND_TYPES == 22
    assert chem.bond_code_from_rdkit(12) == jchem.bond_code_from_rdkit(12) == 12
    assert chem.have_rdkit() == jchem.have_rdkit()
    monkeypatch.setitem(sys.modules, "rdkit", types.ModuleType("rdkit"))
    assert chem.have_rdkit()
    monkeypatch.delitem(sys.modules, "rdkit")
    installed = pyg_compat.install_pyg_stubs()
    try:   # the PyG-unpickle stand-in is not RDKit, to either package
        assert "rdkit" in installed and not chem.have_rdkit() and not jchem.have_rdkit()
    finally:
        pyg_compat.uninstall_pyg_stubs()
