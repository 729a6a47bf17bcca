"""The RDKit and py3Dmol helpers (``tsdiff_tpu_torch/utils/chem_rdkit.py``,
``utils/visualize.py``) and COV/MAT's ``rdmol`` route against the JAX
package's, on the CPU.

RDKit is not installed here: the helpers take duck-typed stand-ins (a
molecule whose conformer records ``SetAtomPosition``), and the ``rdmol``
route of ``rmsd_confusion_matrix`` runs on a stand-in RDKit put in
``sys.modules`` (``GetBestRMS`` a centred RMSD over the atoms ``RemoveHs``
keeps, ``MMFFOptimizeMolecule`` a recorded contraction), which both
packages import; their matrices must be equal.  With RDKit installed, the
last test holds the real helpers of both packages to each other."""

import sys
import types

import numpy as np
import pytest

from tsdiff_tpu.eval.covmat import rmsd_confusion_matrix as jax_rmsd_confusion_matrix
from tsdiff_tpu.utils import chem_rdkit as jax_chem
from tsdiff_tpu.utils import visualize as jax_visualize

from tsdiff_tpu_torch.eval.covmat import rmsd_confusion_matrix
from tsdiff_tpu_torch.utils import chem_rdkit, visualize


class Conformer:
    def __init__(self, pos):
        self.pos = np.array(pos, dtype=np.float64)

    def SetAtomPosition(self, i, xyz):
        assert isinstance(xyz, list) and all(type(x) is float for x in xyz)
        self.pos[i] = xyz


class Mol:
    def __init__(self, atom_type, pos):
        self.atom_type = np.asarray(atom_type)
        self.conformers = [Conformer(pos)]

    def GetConformer(self, i):
        return self.conformers[i]


def test_set_rdmol_positions_copies_and_sets(tmp_path):
    mol = Mol([6, 1, 8], np.zeros((3, 3)))
    pos = np.arange(9, dtype=np.float32).reshape(3, 3) / 7
    got = chem_rdkit.set_rdmol_positions(mol, pos)
    want = jax_chem.set_rdmol_positions(mol, pos)
    assert got is not mol and np.array_equal(mol.GetConformer(0).pos, np.zeros((3, 3)))
    np.testing.assert_array_equal(got.GetConformer(0).pos, want.GetConformer(0).pos)
    np.testing.assert_array_equal(got.GetConformer(0).pos, pos.astype(np.float64))


def test_write_xyz_byte_equal_to_jax(tmp_path):
    rng = np.random.default_rng(0)
    frames = [(rng.integers(1, 10, size=n), rng.normal(size=(n, 3))) for n in (4, 6)]
    for name, mod in (("port", visualize), ("jax", jax_visualize)):
        path = str(tmp_path / f"{name}.xyz")
        for i, (z, pos) in enumerate(frames):
            mod.write_xyz(path, z, pos, comment=f"frame {i}", append=i > 0)
    assert (tmp_path / "port.xyz").read_bytes() == (tmp_path / "jax.xyz").read_bytes()
    assert (tmp_path / "port.xyz").read_text().count("frame") == 2


def test_visualize_mol_builds_the_same_view(monkeypatch):
    calls = []

    class View:
        def __init__(self, **kw):
            calls.append(("view", kw))

        def __getattr__(self, name):
            return lambda *a, **kw: calls.append((name, a, kw))

    monkeypatch.setitem(sys.modules, "py3Dmol", types.SimpleNamespace(view=View, SAS="SAS"))
    z, pos = np.array([6, 8, 1]), np.arange(9.0).reshape(3, 3)
    visualize.visualize_mol(z, pos, surface=True)
    port = list(calls)
    calls.clear()
    jax_visualize.visualize_mol(z, pos, surface=True)
    assert port == calls and ("addModel", (visualize.format_xyz_block(z, pos), "xyz"), {}) in port


@pytest.fixture
def fake_rdkit(monkeypatch):
    """RDKit stand-ins in ``sys.modules``; returns the MMFF call log."""
    mmff = []

    def remove_hs(mol):
        keep = mol.atom_type != 1
        return Mol(mol.atom_type[keep], mol.GetConformer(0).pos[keep])

    def best_rms(probe, ref):
        a, b = probe.GetConformer(0).pos, ref.GetConformer(0).pos
        a, b = a - a.mean(0), b - b.mean(0)
        return float(np.sqrt(((a - b) ** 2).sum(-1).mean()))

    def optimize(mol):
        mmff.append(mol.GetConformer(0).pos.copy())
        mol.GetConformer(0).pos *= 0.9
        return 0

    rdkit = types.ModuleType("rdkit")
    chem = types.ModuleType("rdkit.Chem")
    parts = {"rdMolAlign": {"GetBestRMS": best_rms}, "rdmolops": {"RemoveHs": remove_hs},
             "rdForceFieldHelpers": {"MMFFOptimizeMolecule": optimize}}
    rdkit.Chem = chem
    monkeypatch.setitem(sys.modules, "rdkit", rdkit)
    monkeypatch.setitem(sys.modules, "rdkit.Chem", chem)
    for name, attrs in parts.items():
        mod = types.ModuleType(f"rdkit.Chem.{name}")
        for k, v in attrs.items():
            setattr(mod, k, v)
        setattr(chem, name, mod)
        monkeypatch.setitem(sys.modules, f"rdkit.Chem.{name}", mod)
    return mmff


@pytest.mark.parametrize("use_ff", [False, True], ids=["plain", "mmff"])
def test_rdmol_route_of_the_rmsd_matrix_equals_jax(fake_rdkit, use_ff):
    rng = np.random.default_rng(3)
    atom_type = np.array([6, 6, 8, 1, 1, 7])
    data = {"pos_ref": rng.normal(size=(3, 6, 3)), "pos_gen": rng.normal(size=(4, 6, 3)),
            "atom_type": atom_type, "rdmol": Mol(atom_type, np.zeros((6, 3)))}
    got = rmsd_confusion_matrix(data, use_ff=use_ff)
    calls = len(fake_rdkit)
    want = jax_rmsd_confusion_matrix(data, use_ff=use_ff)
    assert got.shape == (3, 4)
    np.testing.assert_array_equal(got, want)
    assert calls == len(fake_rdkit) - calls == (4 if use_ff else 0)
    # the stand-in's RMSD of the heavy atoms, centred, with MMFF's contraction
    scale = 0.9 if use_ff else 1.0
    heavy = atom_type != 1
    g = data["pos_gen"][1][heavy] * scale
    r = data["pos_ref"][2][heavy]
    g, r = g - g.mean(0), r - r.mean(0)
    np.testing.assert_allclose(got[2, 1], np.sqrt(((g - r) ** 2).sum(-1).mean()), rtol=1e-12)


def test_helpers_against_jax_with_rdkit():
    pytest.importorskip("rdkit")
    from rdkit import Chem
    from rdkit.Chem import AllChem

    mol = Chem.AddHs(Chem.MolFromSmiles("CCO"))
    AllChem.EmbedMolecule(mol, randomSeed=0)
    assert chem_rdkit.mol_to_smiles(mol) == jax_chem.mol_to_smiles(mol)
    assert chem_rdkit.mol_to_smiles_without_hs(mol) == jax_chem.mol_to_smiles_without_hs(mol)
    assert chem_rdkit.get_atom_symbol(8) == jax_chem.get_atom_symbol(8) == "O"
    pos = mol.GetConformer(0).GetPositions() + 0.1
    moved = chem_rdkit.set_rdmol_positions(mol, pos)
    assert chem_rdkit.get_best_rmsd(moved, mol) == jax_chem.get_best_rmsd(moved, mol)
