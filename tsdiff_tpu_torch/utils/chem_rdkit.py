"""RDKit helper functions (import-gated; host-side only).

Port of ``tsdiff_tpu/utils/chem_rdkit.py`` (reference utils/chem.py):
conformer position setters, best RMSD, SMILES helpers.  RDKit is imported
inside the functions that need it; the card's paths never import this
module.
"""

from __future__ import annotations

from copy import deepcopy

import numpy as np


def set_rdmol_positions(rdkit_mol, pos):
    """A copy of ``rdkit_mol`` with its first conformer at ``pos``
    (reference utils/chem.py:52-71)."""
    mol = deepcopy(rdkit_mol)
    conf = mol.GetConformer(0)
    for i in range(np.asarray(pos).shape[0]):
        conf.SetAtomPosition(i, [float(x) for x in pos[i]])
    return mol


def get_best_rmsd(probe, ref) -> float:
    """Heavy-atom best RMSD via RDKit (reference utils/chem.py:137-141)."""
    from rdkit.Chem import rdMolAlign as MA
    from rdkit.Chem.rdmolops import RemoveHs

    return float(MA.GetBestRMS(RemoveHs(probe), RemoveHs(ref)))


def mol_to_smiles(mol) -> str:
    from rdkit import Chem

    return Chem.MolToSmiles(mol, allHsExplicit=True)


def mol_to_smiles_without_hs(mol) -> str:
    from rdkit import Chem

    return Chem.MolToSmiles(Chem.RemoveHs(mol))


def get_atom_symbol(atomic_number: int) -> str:
    from rdkit.Chem import GetPeriodicTable

    return GetPeriodicTable().GetElementSymbol(int(atomic_number))
