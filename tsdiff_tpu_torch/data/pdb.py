"""Protein PDB featurization and the sidechain-prediction data pipeline.

Port of the JAX package's ``data/pdb.py``, numpy only:

* ``parse_pdb``: the ATOM records of a PDB file (fixed columns, heavy
  atoms, the first model, altloc A);
* ``pdb_to_graph``: a protein graph dict in the legacy molecule layout
  (``r_feat``/``p_feat`` empty, plain bond codes as sparse edges) with the
  per-atom ``is_sidechain``, ``is_alpha``, ``atom2res`` and
  ``atom2alpha_index`` arrays and the identity columns ``write_pdb`` needs.
  Bonds come from RDKit's ``MolFromPDBFile`` when RDKit imports and the
  file's path is given, else from the residue templates of the 20 standard
  amino acids and peptide bonds between consecutive residues;
* ``sample_sidechain_subgraph``: a residue-complete cutoff ball around a
  backbone atom, the training example; ``cover_protein_with_subgraphs``:
  alpha-centred balls until every CA is covered, the inference scaffold;
* ``write_pdb``: graph and coordinates back to ATOM records;
* ``SidechainConformationDataset``: a fresh subgraph per access.

Batches of subgraphs are packed by ``core.graph.from_numpy_graphs``, which
carries ``is_sidechain`` into the batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tsdiff_tpu_torch.chem import BOND_TYPES

#: backbone atom names (reference utils/datasets.py:266: everything else is
#: sidechain)
BACKBONE_NAMES = ("N", "CA", "C", "O")

_S = BOND_TYPES["SINGLE"]
_D = BOND_TYPES["DOUBLE"]
_A = BOND_TYPES["AROMATIC"]

#: intra-residue heavy-atom bonds (standard PDB v3 atom names) for the 20
#: canonical amino acids.  Backbone bonds (N-CA, CA-C, C=O, CA-CB) are shared;
#: the table lists sidechain-internal bonds past CB.  Orders follow the
#: RDKit amino-acid templates (carboxylate/amide C=O double, rings aromatic).
_BACKBONE_BONDS = (("N", "CA", _S), ("CA", "C", _S), ("C", "O", _D))
SIDECHAIN_BONDS = {
    "ALA": (),
    "ARG": (("CB", "CG", _S), ("CG", "CD", _S), ("CD", "NE", _S),
            ("NE", "CZ", _S), ("CZ", "NH1", _S), ("CZ", "NH2", _D)),
    "ASN": (("CB", "CG", _S), ("CG", "OD1", _D), ("CG", "ND2", _S)),
    "ASP": (("CB", "CG", _S), ("CG", "OD1", _D), ("CG", "OD2", _S)),
    "CYS": (("CB", "SG", _S),),
    "GLN": (("CB", "CG", _S), ("CG", "CD", _S), ("CD", "OE1", _D),
            ("CD", "NE2", _S)),
    "GLU": (("CB", "CG", _S), ("CG", "CD", _S), ("CD", "OE1", _D),
            ("CD", "OE2", _S)),
    "GLY": (),
    "HIS": (("CB", "CG", _S), ("CG", "ND1", _A), ("CG", "CD2", _A),
            ("ND1", "CE1", _A), ("CD2", "NE2", _A), ("CE1", "NE2", _A)),
    "ILE": (("CB", "CG1", _S), ("CB", "CG2", _S), ("CG1", "CD1", _S)),
    "LEU": (("CB", "CG", _S), ("CG", "CD1", _S), ("CG", "CD2", _S)),
    "LYS": (("CB", "CG", _S), ("CG", "CD", _S), ("CD", "CE", _S),
            ("CE", "NZ", _S)),
    "MET": (("CB", "CG", _S), ("CG", "SD", _S), ("SD", "CE", _S)),
    "PHE": (("CB", "CG", _S), ("CG", "CD1", _A), ("CG", "CD2", _A),
            ("CD1", "CE1", _A), ("CD2", "CE2", _A), ("CE1", "CZ", _A),
            ("CE2", "CZ", _A)),
    "PRO": (("CB", "CG", _S), ("CG", "CD", _S), ("CD", "N", _S)),
    "SER": (("CB", "OG", _S),),
    "THR": (("CB", "OG1", _S), ("CB", "CG2", _S)),
    "TRP": (("CB", "CG", _S), ("CG", "CD1", _A), ("CG", "CD2", _A),
            ("CD1", "NE1", _A), ("NE1", "CE2", _A), ("CD2", "CE2", _A),
            ("CD2", "CE3", _A), ("CE2", "CZ2", _A), ("CE3", "CZ3", _A),
            ("CZ2", "CH2", _A), ("CZ3", "CH2", _A)),
    "TYR": (("CB", "CG", _S), ("CG", "CD1", _A), ("CG", "CD2", _A),
            ("CD1", "CE1", _A), ("CD2", "CE2", _A), ("CE1", "CZ", _A),
            ("CE2", "CZ", _A), ("CZ", "OH", _S)),
    "VAL": (("CB", "CG1", _S), ("CB", "CG2", _S)),
}

_ELEMENT_Z = {
    "H": 1, "C": 6, "N": 7, "O": 8, "F": 9, "P": 15, "S": 16, "SE": 34,
    "CL": 17, "BR": 35, "I": 53,
}


@dataclasses.dataclass
class PdbAtoms:
    """Columns of the parsed ATOM records (heavy atoms, single model)."""

    name: list[str]        # PDB atom name, stripped ("CA", "OD1", ...)
    resname: list[str]     # 3-letter residue name
    chain: list[str]       # chain id
    resnum: np.ndarray     # (n,) int author residue number
    icode: list[str]       # insertion code column 27 ("" when absent)
    element: list[str]     # element symbol, uppercased
    pos: np.ndarray        # (n, 3) float32

    def __len__(self) -> int:
        return len(self.name)

    def residue_key(self, i: int) -> tuple[str, int, str]:
        """Identity of atom i's residue — includes the insertion code so
        e.g. 100 and 100A on the same chain stay distinct residues."""
        return (self.chain[i], int(self.resnum[i]), self.icode[i])


def parse_pdb(text: str, keep_hydrogens: bool = False) -> PdbAtoms:
    """Parse ATOM records of a PDB file (fixed columns, PDB v3).

    Stops at the first ENDMDL (single-model, like the reference's
    ``MolFromPDBFile`` default).  HETATM and altloc B+ records are skipped.
    """
    name, resname, chain, resnum, icode, element, pos = [], [], [], [], [], [], []
    for line in text.splitlines():
        rec = line[:6].strip()
        if rec == "ENDMDL":
            break
        if rec != "ATOM":
            continue
        altloc = line[16].strip()
        if altloc not in ("", "A"):
            continue
        el = line[76:78].strip().upper()
        if not el:
            # infer from the atom-name columns (cols 13-14 hold the element)
            el = "".join(c for c in line[12:14] if c.isalpha()).upper()
            if len(el) == 2 and el not in _ELEMENT_Z:
                el = el[-1]
        if el == "H" and not keep_hydrogens:
            continue
        name.append(line[12:16].strip())
        resname.append(line[17:20].strip())
        chain.append(line[21])
        resnum.append(int(line[22:26]))
        icode.append(line[26].strip() if len(line) > 26 else "")
        element.append(el)
        pos.append((float(line[30:38]), float(line[38:46]), float(line[46:54])))
    return PdbAtoms(
        name=name, resname=resname, chain=chain,
        resnum=np.asarray(resnum, np.int64), icode=icode, element=element,
        pos=np.asarray(pos, np.float32).reshape(-1, 3),
    )


def _template_bonds(atoms: PdbAtoms) -> tuple[np.ndarray, np.ndarray]:
    """Residue-template bond perception (RDKit-free path).

    Intra-residue bonds from ``SIDECHAIN_BONDS`` + backbone bonds; peptide
    C(i)-N(i+1) bonds between consecutive residues of the same chain; OXT
    bonded to the terminal C.  Unknown residues get backbone bonds only.
    Returns sparse ``edge_index (2, E)`` / ``edge_type (E,)`` with both
    directions, sorted like the reference (row-major).
    """
    n = len(atoms)
    # residue key (incl. insertion code) -> {atom name -> index}
    by_res: dict[tuple[str, int, str], dict[str, int]] = {}
    order: list[tuple[str, int, str]] = []
    for i in range(n):
        key = atoms.residue_key(i)
        if key not in by_res:
            by_res[key] = {}
            order.append(key)
        by_res[key].setdefault(atoms.name[i], i)

    rows, cols, types = [], [], []

    def add(i: int, j: int, t: int) -> None:
        rows.extend((i, j))
        cols.extend((j, i))
        types.extend((t, t))

    for key in order:
        res = by_res[key]
        i0 = next(iter(res.values()))
        rn = atoms.resname[i0]
        for a, b, t in _BACKBONE_BONDS + SIDECHAIN_BONDS.get(rn, ()):
            if a in res and b in res:
                add(res[a], res[b], t)
        if "CB" in res and "CA" in res:
            add(res["CA"], res["CB"], _S)
        if "OXT" in res and "C" in res:
            add(res["C"], res["OXT"], _S)

    # peptide bonds: file-consecutive residues of the same chain whose C-N
    # distance is peptide-like (~1.33 A; 2.0 cutoff rejects chain breaks).
    # Distance-based so insertion-coded numbering (100 -> 100A) still bonds.
    for prev, cur in zip(order, order[1:]):
        if prev[0] == cur[0] and "C" in by_res[prev] and "N" in by_res[cur]:
            ci, ni = by_res[prev]["C"], by_res[cur]["N"]
            if np.linalg.norm(atoms.pos[ci] - atoms.pos[ni]) <= 2.0:
                add(ci, ni, _S)

    edge_index = np.asarray([rows, cols], np.int32).reshape(2, -1)
    edge_type = np.asarray(types, np.int32)
    perm = np.argsort(edge_index[0] * n + edge_index[1], kind="stable")
    return edge_index[:, perm], edge_type[perm]


def _rdkit_bonds(
    pdb_path: str, expected_atoms: int | None = None
) -> tuple[np.ndarray, np.ndarray] | None:
    """Bond perception via RDKit (the reference path,
    utils/datasets.py:224, 292-305).

    Returns None (caller falls back to templates) when RDKit's atom list
    does not line up with our ATOM-record parse — e.g. the file carries
    HETATM records RDKit includes but ``parse_pdb`` skips — since the bond
    indices would then point at the wrong atoms."""
    from rdkit import Chem

    mol = Chem.rdmolfiles.MolFromPDBFile(pdb_path)
    if mol is None:
        return None
    n = mol.GetNumAtoms()
    if expected_atoms is not None and n != expected_atoms:
        return None
    rows, cols, types = [], [], []
    for bond in mol.GetBonds():
        s, e = bond.GetBeginAtomIdx(), bond.GetEndAtomIdx()
        t = int(bond.GetBondType())
        rows += [s, e]
        cols += [e, s]
        types += [t, t]
    edge_index = np.asarray([rows, cols], np.int32).reshape(2, -1)
    edge_type = np.asarray(types, np.int32)
    perm = np.argsort(edge_index[0] * n + edge_index[1], kind="stable")
    return edge_index[:, perm], edge_type[perm]


def pdb_to_graph(
    pdb_text: str,
    name: str = "",
    use_rdkit: bool | None = None,
    pdb_path: str | None = None,
) -> dict | None:
    """PDB text -> protein graph dict (reference ``pdb_to_data``,
    utils/datasets.py:223-328).

    Returns ``None`` for proteins with no sidechain atoms (GLY-only,
    reference :285-289) or no bonds (reference :302-303).  Extra keys over
    the molecule dicts: ``is_sidechain``/``is_alpha`` (n,) bool,
    ``atom2res`` (n,) int (0-based, min-shifted), ``atom2alpha_index`` (n,)
    int (index of the residue's CA atom, -1 if the residue has none —
    reference :280-283 builds the same map through a res->alpha table).
    """
    atoms = parse_pdb(pdb_text)
    n = len(atoms)
    if n == 0:
        return None

    names = np.asarray(atoms.name)
    is_alpha = names == "CA"
    is_sidechain = ~np.isin(names, BACKBONE_NAMES)
    is_sidechain &= names != "OXT"  # terminal carboxyl O is backbone
    if not is_sidechain.any():
        return None

    # residue index: 0-based over distinct residues (incl. insertion code)
    # in file order, min-shifted like the reference (:275)
    keys = [atoms.residue_key(i) for i in range(n)]
    uniq: dict[tuple[str, int, str], int] = {}
    for k in keys:
        uniq.setdefault(k, len(uniq))
    atom2res = np.asarray([uniq[k] for k in keys], np.int64)

    # residue -> its CA atom index; -1 when absent (reference :280-283)
    res2alpha = -np.ones(atom2res.max() + 1, np.int64)
    res2alpha[atom2res[is_alpha]] = np.nonzero(is_alpha)[0]
    atom2alpha_index = res2alpha[atom2res]

    z = np.asarray([_ELEMENT_Z.get(e, 0) for e in atoms.element], np.int32)

    bonds = None
    if use_rdkit and pdb_path is None:
        raise ValueError("use_rdkit=True requires pdb_path (RDKit parses the file)")
    if (use_rdkit is None or use_rdkit) and pdb_path is not None:
        try:
            bonds = _rdkit_bonds(pdb_path, expected_atoms=n)
        except ImportError:
            if use_rdkit:
                raise
    if bonds is None:
        bonds = _template_bonds(atoms)
    edge_index, edge_type = bonds
    if edge_index.shape[1] == 0:
        return None

    return dict(
        atom_type=z,
        r_feat=np.zeros((n, 0), np.float32),
        p_feat=np.zeros((n, 0), np.float32),
        pos=atoms.pos,
        edge_index=edge_index,
        edge_type=edge_type,
        smiles=name,
        is_sidechain=is_sidechain,
        is_alpha=is_alpha,
        atom2res=atom2res,
        atom2alpha_index=atom2alpha_index,
        # identity columns kept for round-tripping back to PDB (write_pdb)
        atom_name=list(atoms.name),
        res_name=list(atoms.resname),
        chain=list(atoms.chain),
        res_num=atoms.resnum.copy(),
        icode=list(atoms.icode),
    )


def pdb_file_to_graph(path: str, name: str | None = None, **kw) -> dict | None:
    with open(path) as f:
        text = f.read()
    return pdb_to_graph(text, name=name or path, pdb_path=path, **kw)


def _ball_subgraph(
    graph: dict, center: int, cutoff: float, with_mapping: bool
) -> dict | None:
    """Residue-complete cutoff ball around ``center``: keep atoms within
    ``cutoff``, extend to whole residues, remap indices.  ``None`` when no
    sidechain atom survives (reference utils/datasets.py:1186-1188,
    1267-1268)."""
    is_sidechain = np.asarray(graph["is_sidechain"], bool)
    pos = np.asarray(graph["pos"])
    atom2res = np.asarray(graph["atom2res"])

    dist = np.linalg.norm(pos - pos[center], axis=-1)
    keep_res = np.zeros(atom2res.max() + 1, bool)
    np.logical_or.at(keep_res, atom2res[dist <= cutoff], True)
    keep_atom = keep_res[atom2res]
    if not (is_sidechain & keep_atom).any():
        return None

    keep_index = np.nonzero(keep_atom)[0]
    mapping = -np.ones(len(pos), np.int64)
    mapping[keep_index] = np.arange(len(keep_index))

    ei = np.asarray(graph["edge_index"])
    et = np.asarray(graph["edge_type"])
    keep_edge = keep_atom[ei[0]] & keep_atom[ei[1]]

    m = len(keep_index)
    sub = dict(
        atom_type=np.asarray(graph["atom_type"])[keep_atom],
        r_feat=np.zeros((m, 0), np.float32),
        p_feat=np.zeros((m, 0), np.float32),
        pos=pos[keep_atom].astype(np.float32),
        edge_index=mapping[ei[:, keep_edge]].astype(np.int32),
        edge_type=et[keep_edge],
        smiles=graph.get("smiles", ""),
        is_sidechain=is_sidechain[keep_atom],
        atom2res=atom2res[keep_atom],
    )
    for col in ("atom_name", "res_name", "chain", "icode"):
        if col in graph:
            sub[col] = [graph[col][i] for i in keep_index]
    if "res_num" in graph:
        sub["res_num"] = np.asarray(graph["res_num"])[keep_atom]
    if with_mapping:
        sub["mapping"] = keep_index
    return sub


def _ball_keep_atoms(graph: dict, center: int, cutoff: float) -> np.ndarray:
    pos = np.asarray(graph["pos"])
    atom2res = np.asarray(graph["atom2res"])
    dist = np.linalg.norm(pos - pos[center], axis=-1)
    keep_res = np.zeros(atom2res.max() + 1, bool)
    np.logical_or.at(keep_res, atom2res[dist <= cutoff], True)
    return keep_res[atom2res]


def sample_sidechain_subgraph(
    graph: dict,
    rng: np.random.Generator,
    cutoff: float = 10.0,
    fix_subgraph: bool = False,
) -> dict | None:
    """Residue-complete cutoff-ball subgraph around a random backbone atom.

    Mirrors ``SidechainConformationDataset.__getitem__`` (reference
    utils/datasets.py:1146-1203): (1) pick a backbone center (middle atom if
    ``fix_subgraph``), (2) keep atoms within ``cutoff``, (3) extend the kept
    set to whole residues, (4) remap indices.  Returns ``None`` when the
    subgraph contains no sidechain atoms (reference :1186-1188).
    """
    is_sidechain = np.asarray(graph["is_sidechain"], bool)
    backbone_index = np.nonzero(~is_sidechain)[0]
    if fix_subgraph:
        center = backbone_index[len(backbone_index) // 2]
    else:
        center = backbone_index[rng.integers(0, len(backbone_index))]
    return _ball_subgraph(graph, center, cutoff, with_mapping=False)


def pack_sidechain_mask(graphs: list[dict], max_nodes: int) -> np.ndarray:
    """(B, N) bool sidechain mask aligned with ``from_numpy_graphs`` padding
    (padding slots are False == backbone == frozen)."""
    B = len(graphs)
    out = np.zeros((B, max_nodes), bool)
    for b, g in enumerate(graphs):
        sc = np.asarray(g["is_sidechain"], bool)
        out[b, : len(sc)] = sc
    return out


def cover_protein_with_subgraphs(
    graph: dict,
    rng: np.random.Generator,
    cutoff: float = 10.0,
) -> list[dict]:
    """Cover a full protein with alpha-centered residue-complete subgraphs.

    Working counterpart of the reference's unfinished
    ``accumulate_grad_from_subgraph`` subgraph-preparation loop (reference
    utils/datasets.py:1210-1280; upstream the function dereferences
    ``pos.deivce`` and indexes a list with a comma — dead code): repeatedly
    pick an uncovered CA atom, take its residue-complete cutoff ball, mark
    the kept atoms covered, until every CA is covered.  Each subgraph dict
    carries ``mapping`` — original atom indices — so per-atom model outputs
    can be scattered back onto the full protein.  Subgraphs with no
    sidechain atom are skipped (reference :1267-1268) but still count as
    covered.
    """
    is_alpha = np.asarray(graph["is_alpha"], bool)
    n = len(np.asarray(graph["atom_type"]))

    covered = np.zeros(n, bool)
    subs: list[dict] = []
    while (is_alpha & ~covered).any():
        alpha_index = np.nonzero(is_alpha & ~covered)[0]
        center = alpha_index[rng.integers(0, len(alpha_index))]
        covered |= _ball_keep_atoms(graph, center, cutoff)
        sub = _ball_subgraph(graph, center, cutoff, with_mapping=True)
        if sub is not None:
            sub["center"] = int(center)  # full-protein atom index of the ball center
            subs.append(sub)
    return subs


_Z_ELEMENT = {v: k for k, v in _ELEMENT_Z.items()}


def write_pdb(graph: dict, pos: np.ndarray | None = None) -> str:
    """Protein graph dict -> PDB ATOM records (inverse of ``parse_pdb`` for
    graphs produced by ``pdb_to_graph``, which keeps the identity columns).
    ``pos`` overrides the stored coordinates (e.g. regenerated sidechains).
    """
    if "atom_name" not in graph:
        raise ValueError("graph lacks atom_name/res_name columns (not from pdb_to_graph?)")
    pos = np.asarray(pos if pos is not None else graph["pos"], np.float32)
    z = np.asarray(graph["atom_type"])
    if len(z) > 99999 or (len(z) and int(np.max(graph["res_num"])) > 9999):
        raise ValueError(
            "PDB fixed columns cap at 99999 atoms / residue number 9999; "
            "this protein exceeds the format"
        )
    icodes = graph.get("icode") or [""] * len(z)
    lines = []
    for i in range(len(z)):
        el = _Z_ELEMENT.get(int(z[i]), "X")
        nm = graph["atom_name"][i]
        nm_field = f" {nm:<3s}" if len(nm) < 4 else nm
        ic = (icodes[i] or " ")[:1]
        x, y, w = pos[i]
        lines.append(
            f"ATOM  {i + 1:>5d} {nm_field:<4s} {graph['res_name'][i]:<3s} "
            f"{graph['chain'][i]}{int(graph['res_num'][i]):>4d}{ic}   "
            f"{x:8.3f}{y:8.3f}{w:8.3f}{1.0:6.2f}{0.0:6.2f}          {el:>2s}"
        )
    lines.append("END")
    return "\n".join(lines) + "\n"


class SidechainConformationDataset:
    """Subgraph-sampling dataset over featurized protein graphs
    (reference utils/datasets.py:1129-1208).

    ``__getitem__`` draws a fresh residue-complete subgraph each call
    (seeded per (epoch, idx) via the ``rng``); iterate + pack with
    ``from_numpy_graphs`` + ``pack_sidechain_mask``.
    """

    def __init__(self, graphs: list[dict], cutoff: float = 10.0,
                 fix_subgraph: bool = False, seed: int = 0):
        self.graphs = [g for g in graphs if g is not None]
        self.cutoff = cutoff
        self.fix_subgraph = fix_subgraph
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.graphs)

    def __getitem__(self, idx: int) -> dict | None:
        return sample_sidechain_subgraph(
            self.graphs[idx], self.rng, self.cutoff, self.fix_subgraph
        )
