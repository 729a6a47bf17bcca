"""Reaction featurization: atom-mapped SMARTS ``R>>P`` (+ optional TS xyz) ->
numpy graph dict.

The port's copy of ``tsdiff_tpu/data/featurize.py``, itself a re-derivation
of the reference's ``generate_ts_data2`` (utils/datasets.py:407-519), giving
plain-numpy graphs (the on-disk format of ``data/dataset.py``).  RDKit is
imported only here, when SMARTS strings are featurized; molecules passed in
as objects need only their duck-typed Mol/Atom/Bond API.

Semantics:
  * atom-map-number permutation alignment of R and P atom orders;
  * per-atom integer feature codes from the 8 RDKit getters, the feat_dict
    growing on unseen values;
  * union adjacency of R and P; per-edge R and P bond types with 0 = no bond;
    condensed ``edge_type = r * 22 + p``;
  * edges sorted by (row * N + col);
  * one-hot feature encoding concatenated over the getters -> feat_dim
    (25 in production).
"""

from __future__ import annotations

import numpy as np

from tsdiff_tpu_torch.chem import NUM_BOND_TYPES
from tsdiff_tpu_torch.data.parse_xyz import read_xyz_block

#: The 8 RDKit atom-feature getters of the production feat_dict
#: (reference preprocessing.py:131-140), in order.
DEFAULT_FEATURES = (
    "GetIsAromatic",
    "GetFormalCharge",
    "GetHybridization",
    "GetTotalNumHs",
    "GetTotalValence",
    "GetTotalDegree",
    "GetChiralTag",
    "IsInRing",
)


def default_feat_dict() -> dict:
    return {k: {} for k in DEFAULT_FEATURES}


def _require_rdkit():
    try:
        import rdkit
        from rdkit import Chem

        if getattr(rdkit, "__tsdiff_tpu_stub__", False):
            # the PyG-unpickle stand-in (data/pyg_compat.py), not real rdkit
            raise ImportError("rdkit module is a pyg_compat unpickle stub")
        return Chem
    except ImportError as e:
        raise ImportError(
            "RDKit is required for SMARTS featurization. Install rdkit, or "
            "use pre-featurized datasets (tsdiff_tpu.v1 pickles)."
        ) from e


def _mol_smiles(mol) -> str:
    try:
        from rdkit import Chem

        return Chem.MolToSmiles(mol)
    except Exception:
        return getattr(mol, "smiles", "")


def _atom_features(atom, feat_dict: dict) -> list[int]:
    codes = []
    for getter, vocab in feat_dict.items():
        val = getattr(atom, getter)()
        if val not in vocab:
            vocab[val] = len(vocab)
        codes.append(vocab[val])
    return codes


def generate_ts_data(
    r_smarts,
    p_smarts,
    xyz_block=None,
    feat_dict: dict | None = None,
) -> tuple[dict, dict]:
    """SMARTS pair -> graph dict.  Returns (graph, feat_dict).

    graph keys: atom_type (n,), r_feat/p_feat (n, n_getters) integer codes
    (call :func:`one_hot_features` afterwards), pos (n,3), edge_index (2,E),
    edge_type (E,) condensed, smiles.
    """
    if feat_dict is None:
        feat_dict = default_feat_dict()

    if isinstance(r_smarts, str) and isinstance(p_smarts, str):
        Chem = _require_rdkit()
        r = Chem.MolFromSmarts(r_smarts)
        p = Chem.MolFromSmarts(p_smarts)
        Chem.SanitizeMol(r)
        Chem.SanitizeMol(p)
    else:
        # mol objects passed directly: only the duck-typed Mol/Atom/Bond API
        # below is used (RDKit not required — enables RDKit-free fixtures)
        r, p = r_smarts, p_smarts
    n = r.GetNumAtoms()
    assert p.GetNumAtoms() == n, "R and P atom counts differ"

    if xyz_block is not None:
        if isinstance(xyz_block, str):
            _, pos = read_xyz_block(xyz_block)
        else:
            pos = np.asarray(xyz_block, dtype=np.float64)
        assert len(pos) == n
    else:
        pos = np.zeros((n, 3))

    # align both molecules to atom-map order (map numbers are 1-based)
    r_perm = np.array([a.GetAtomMapNum() for a in r.GetAtoms()]) - 1
    p_perm = np.array([a.GetAtomMapNum() for a in p.GetAtoms()]) - 1
    r_perm_inv = np.argsort(r_perm)
    p_perm_inv = np.argsort(p_perm)

    r_atoms = list(r.GetAtoms())
    p_atoms = list(p.GetAtoms())
    r_z = [r_atoms[i].GetAtomicNum() for i in r_perm_inv]
    p_z = [p_atoms[i].GetAtomicNum() for i in p_perm_inv]
    assert r_z == p_z, "atom-map inconsistency between R and P"
    r_feat = np.array([_atom_features(r_atoms[i], feat_dict) for i in r_perm_inv])
    p_feat = np.array([_atom_features(p_atoms[i], feat_dict) for i in p_perm_inv])

    def adjacency(mol):
        # == Chem.rdmolops.GetAdjacencyMatrix, via the bond list (duck-typed)
        adj = np.zeros((n, n), dtype=np.int64)
        for b in mol.GetBonds():
            i, j = b.GetBeginAtomIdx(), b.GetEndAtomIdx()
            adj[i, j] = adj[j, i] = 1
        return adj

    r_adj = adjacency(r)
    p_adj = adjacency(p)
    r_adj = r_adj[r_perm_inv][:, r_perm_inv]
    p_adj = p_adj[p_perm_inv][:, p_perm_inv]
    union = r_adj + p_adj
    row, col = union.nonzero()

    def bond_code(mol, perm_inv, i, j):
        b = mol.GetBondBetweenAtoms(int(perm_inv[i]), int(perm_inv[j]))
        return int(b.GetBondType()) if b is not None else 0

    r_types = np.array([bond_code(r, r_perm_inv, i, j) for i, j in zip(row, col)])
    p_types = np.array([bond_code(p, p_perm_inv, i, j) for i, j in zip(row, col)])

    order = np.argsort(row * n + col, kind="stable")
    edge_index = np.stack([row, col])[:, order].astype(np.int32)
    edge_type = (r_types * NUM_BOND_TYPES + p_types)[order].astype(np.int32)

    graph = dict(
        atom_type=np.asarray(r_z, dtype=np.int32),
        r_feat=r_feat.astype(np.int32),
        p_feat=p_feat.astype(np.int32),
        pos=pos.astype(np.float32),
        edge_index=edge_index,
        edge_type=edge_type,
        smiles=f"{r_smarts if isinstance(r_smarts, str) else _mol_smiles(r)}"
        f">>{p_smarts if isinstance(p_smarts, str) else _mol_smiles(p)}",
    )
    return graph, feat_dict


def one_hot_features(graphs: list[dict], feat_dict: dict) -> list[dict]:
    """Replace integer feature codes by concatenated one-hots
    (reference preprocessing.py:152-164).  feat_dim = sum of vocab sizes."""
    num_cls = [len(v) for v in feat_dict.values()]
    for g in graphs:
        for key in ("r_feat", "p_feat"):
            codes = g[key]
            if codes.ndim == 2 and codes.shape[1] == len(num_cls):
                onehots = [
                    np.eye(nc, dtype=np.float32)[codes[:, k]]
                    for k, nc in enumerate(num_cls)
                ]
                g[key] = np.concatenate(onehots, axis=-1)
    return graphs


def featurize_smarts_list(
    smarts_list: list[str], feat_dict: dict
) -> list[dict]:
    """Test-time preprocessing of raw reaction SMARTS (reference sampling.py:45-67)."""
    graphs = []
    for smarts in smarts_list:
        r, p = smarts.split(">>")
        g, _ = generate_ts_data(r, p, None, feat_dict=feat_dict)
        graphs.append(g)
    return one_hot_features(graphs, feat_dict)
