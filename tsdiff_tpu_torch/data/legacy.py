"""GeoDiff-legacy conformer data: single-molecule graphs (no reactant and
product), the input of the dual encoder and of COV/MAT.

A legacy graph dict holds ``atom_type (n,)``, zero-width ``r_feat``/
``p_feat`` (n, 0), so that the padded-batch machinery of the reaction
graphs applies unchanged, ``pos (n, 3)``, ``edge_index (2, E)`` and
``edge_type (E,)`` with the plain RDKit bond codes, and ``smiles``.

``rdmol_to_data``, ``preprocess_geom_dataset`` and
``preprocess_iso17_dataset`` featurize RDKit molecules and need RDKit;
``ConformationDataset`` and ``PackedConformationDataset`` read graphs
already featurized.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from tsdiff_tpu_torch.data.dataset import TSDataset


def _require_rdkit(what: str) -> None:
    from tsdiff_tpu_torch.chem import have_rdkit

    if not have_rdkit():
        raise ImportError(f"{what} featurizes RDKit molecules and needs RDKit, which is "
                          "not installed")


def rdmol_to_data(mol, smiles: str | None = None) -> dict:
    """An RDKit molecule with one conformer -> a legacy graph dict, edges in
    row-major order."""
    _require_rdkit("rdmol_to_data")
    from rdkit import Chem

    if mol.GetNumConformers() != 1:
        raise ValueError("rdmol_to_data needs a molecule with exactly one conformer")
    n = mol.GetNumAtoms()
    pos = np.asarray(mol.GetConformer(0).GetPositions(), dtype=np.float32)
    z = np.array([a.GetAtomicNum() for a in mol.GetAtoms()], dtype=np.int32)

    row, col, etype = [], [], []
    for bond in mol.GetBonds():
        s, e = bond.GetBeginAtomIdx(), bond.GetEndAtomIdx()
        code = int(bond.GetBondType())
        row += [s, e]
        col += [e, s]
        etype += [code, code]
    edge_index = np.array([row, col], dtype=np.int32)
    etype = np.array(etype, dtype=np.int32)
    perm = np.argsort(edge_index[0] * n + edge_index[1], kind="stable")
    return dict(
        atom_type=z,
        r_feat=np.zeros((n, 0), np.float32),
        p_feat=np.zeros((n, 0), np.float32),
        pos=pos,
        edge_index=edge_index[:, perm],
        edge_type=etype[perm],
        smiles=smiles if smiles is not None else Chem.MolToSmiles(mol),
    )


def preprocess_geom_dataset(base_path: str, dataset_name: str, max_conf: int = 5,
                            train_size: float = 0.8, max_size: int = 2**62,
                            seed: int | None = None):
    """GEOM (qm9 or drugs) conformers -> ``(train, val, test)`` graph lists:
    the ``max_conf`` conformers of highest Boltzmann weight per molecule,
    the split drawn per molecule (seed 2021 by default).  Needs RDKit."""
    import json
    import os
    import pickle as pkl
    import random

    _require_rdkit("preprocess_geom_dataset")
    seed = 2021 if seed is None else seed
    np.random.seed(seed)
    random.seed(seed)
    if dataset_name not in ("qm9", "drugs"):
        raise ValueError(f"unknown GEOM dataset {dataset_name!r}: qm9 or drugs")
    with open(os.path.join(base_path, f"summary_{dataset_name}.json")) as f:
        summ = json.load(f)

    pickle_paths = []
    for _, meta in summ.items():
        if meta.get("uniqueconfs") is None or meta.get("pickle_path") is None:
            continue
        pickle_paths.append(meta["pickle_path"])
        if len(pickle_paths) >= max_size:
            break

    train, val, test = [], [], []
    val_size = (1.0 - train_size) / 2
    for rel in pickle_paths:
        with open(os.path.join(base_path, rel), "rb") as f:
            mol = pkl.load(f)
        u = mol.get("uniqueconfs")
        confs = mol.get("conformers")
        if u is None or u <= 0 or u > len(confs):
            continue
        if u <= max_conf:
            conf_ids = np.arange(u)
        else:
            weights = np.array([c.get("boltzmannweight", -1.0) for c in confs])
            conf_ids = (-weights).argsort()[:max_conf]
        datas = []
        for cid in conf_ids:
            meta = confs[int(cid)]
            g = rdmol_to_data(meta["rd_mol"])
            g["totalenergy"] = float(meta.get("totalenergy", 0.0))
            g["boltzmannweight"] = float(meta.get("boltzmannweight", 0.0))
            datas.append(g)
        eps = np.random.rand()
        if eps <= train_size:
            train.extend(datas)
        elif eps <= train_size + val_size:
            val.extend(datas)
        else:
            test.extend(datas)
    return train, val, test


def preprocess_iso17_dataset(base_path: str):
    """ISO17 conformer pickles -> ``(train, test)`` legacy graph lists.
    Needs RDKit."""
    import os
    import pickle as pkl

    _require_rdkit("preprocess_iso17_dataset")
    out = []
    for split in ("train", "test"):
        with open(os.path.join(base_path, f"iso17_split-0_{split}.pkl"), "rb") as f:
            raw = pkl.load(f)
        out.append([rdmol_to_data(m) for m in raw])
    return tuple(out)


class ConformationDataset(TSDataset):
    """Legacy conformer graphs with their vocabularies: the sorted atom
    types and edge types that occur."""

    def __init__(self, path_or_graphs):
        super().__init__(path_or_graphs)
        self.atom_types = sorted(
            {int(t) for g in self.graphs for t in np.asarray(g["atom_type"]).tolist()})
        self.edge_types = sorted(
            {int(t) for g in self.graphs for t in np.asarray(g["edge_type"]).tolist()})


class PackedConformationDataset(ConformationDataset):
    """One item per molecule (``smiles``): its first graph with ``pos_ref``
    (K, n, 3), the stack of all its conformers, and ``num_pos_ref`` = K;
    the input of the COV/MAT evaluator."""

    def __init__(self, path_or_graphs):
        super().__init__(path_or_graphs)
        by_smiles: dict[str, list[dict]] = defaultdict(list)
        for g in self.graphs:
            by_smiles[g.get("smiles", "")].append(g)
        packed = []
        for graphs in by_smiles.values():
            base = dict(graphs[0])
            base["pos_ref"] = np.stack([np.asarray(g["pos"]) for g in graphs])
            base["num_pos_ref"] = len(graphs)
            packed.append(base)
        self.graphs = packed
