"""Synthetic reaction corpus with a learnable graph -> geometry mapping.

Each reaction is a bent-chain molecule whose bend at atom i is a fixed
function of the (atom_type[i-1], atom_type[i]) pair, through a random table
drawn once from seed 7.  Sizes follow a discretized normal (mean 14, sigma
3.5, clipped to 6..23 atoms).  The reactant carries a ring-closure bond that
the product breaks; r_feat/p_feat are degree/type one-hots at feat_dim 25.
The trained checkpoints under ``artifacts/seeds/ckpts`` were trained on a
corpus drawn this way, so it serves as an unseen test set for them.

Proteins, as PDB text for ``data/pdb.py``:

* ``res_chain``: the protein quality gate's corpus
  (``tests/test_protein_gate.py``): a straight SER/CYS/VAL chain whose every
  chi1 sits at one canonical rotamer;
* ``compact_protein_pdb``: a compact protein at about protein density (0.06
  heavy atoms per cubic angstrom): chain segments of 3.8-A CA steps laid
  back and forth through a box, 6 A apart, with the residue types' heavy
  atoms built from ideal internal coordinates at random rotamers, so that
  a 10-A covering ball holds a few hundred atoms, as in a real protein.
"""

from __future__ import annotations

import numpy as np

from tsdiff_tpu_torch.chem import NUM_BOND_TYPES

FEAT_DIM = 25
N_TYPES = 8  # atom types 1..8


def _bend_table(seed: int = 7) -> np.ndarray:
    """(9, 9, 3) fixed per-type-pair direction updates."""
    rng = np.random.default_rng(seed)
    return rng.normal(scale=0.45, size=(N_TYPES + 1, N_TYPES + 1, 3))


def make_reaction(rng: np.random.Generator, table: np.ndarray) -> dict:
    n = int(np.clip(round(rng.normal(14.0, 3.5)), 6, 23))
    types = rng.integers(1, N_TYPES + 1, size=n).astype(np.int32)

    pos = np.zeros((n, 3), np.float32)
    direction = np.array([1.0, 0.0, 0.0])
    for i in range(1, n):
        direction = direction + table[types[i - 1], types[i]]
        direction = direction / np.linalg.norm(direction)
        pos[i] = pos[i - 1] + 1.5 * direction
    pos -= pos.mean(axis=0)

    # chain bonds in both R and P; a ring-closure bond 0-j present in R only
    bm = np.zeros((n, n), np.int64)
    single_single = 1 * NUM_BOND_TYPES + 1
    for i in range(n - 1):
        bm[i, i + 1] = bm[i + 1, i] = single_single
    j = int(rng.integers(3, n))
    bm[0, j] = bm[j, 0] = 1 * NUM_BOND_TYPES + 0

    # [type one-hot (8) | degree one-hot (4) | pad | in-ring flag | pad]
    def feats(side: str) -> np.ndarray:
        f = np.zeros((n, FEAT_DIM), np.float32)
        f[np.arange(n), types - 1] = 1.0
        r_code = bm // NUM_BOND_TYPES
        p_code = bm % NUM_BOND_TYPES
        adj = (r_code > 0) if side == "r" else (p_code > 0)
        deg = np.clip(adj.sum(1), 0, 3)
        f[np.arange(n), 8 + deg] = 1.0
        if side == "r":
            f[0, 16] = f[j, 16] = 1.0
        return f

    return dict(
        atom_type=types,
        r_feat=feats("r"),
        p_feat=feats("p"),
        pos=pos.astype(np.float32),
        bond_mat=bm,
        smiles=f"synthetic-{n}-{j}",
    )


def make_corpus(count: int, seed: int) -> list[dict]:
    """``count`` reactions from ``np.random.default_rng(seed)``."""
    table = _bend_table()
    rng = np.random.default_rng(seed)
    return [make_reaction(rng, table) for _ in range(count)]


def sparse_edges(graphs: list[dict]) -> list[dict]:
    """The graphs in the on-disk form of featurized and converted datasets:
    ``bond_mat`` replaced by ``edge_index (2, E)`` int32 and ``edge_type
    (E,)`` int32 over its nonzero entries, in row-major order."""
    out = []
    for g in graphs:
        g = dict(g)
        bm = np.asarray(g.pop("bond_mat"))
        row, col = np.nonzero(bm)
        g["edge_index"] = np.stack([row, col]).astype(np.int32)
        g["edge_type"] = bm[row, col].astype(np.int32)
        out.append(g)
    return out


#: heavy-atom types of the conformer corpus and their shares: C, N, O
CONFORMER_HEAVY_TYPES = (6, 7, 8)
CONFORMER_HEAVY_SHARES = (0.7, 0.15, 0.15)


def _place(rng: np.random.Generator, pos: np.ndarray, anchor: int, length: float) -> np.ndarray:
    """A point ``length`` from atom ``anchor`` in a random direction, the one
    of 20 tries farthest from every placed atom."""
    best, best_gap = None, -1.0
    for _ in range(20):
        v = rng.normal(size=3)
        p = pos[anchor] + length * v / np.linalg.norm(v)
        gap = float(np.min(np.linalg.norm(pos - p, axis=1)))
        if gap > best_gap:
            best, best_gap = p, gap
    return best


def make_molecule(rng: np.random.Generator, index: int) -> dict:
    """One synthetic molecule of 9 to 29 atoms in the legacy graph schema:
    a tree of ceil(n / 3) heavy atoms (C, N, O; 1.5 A bonds, 1 in 5 of them
    double) with 0 to 2 hydrogens each (atom type 1, 1.09 A), and its
    geometry."""
    n = int(rng.integers(9, 30))
    h = -(-n // 3)
    heavy = rng.choice(CONFORMER_HEAVY_TYPES, size=h, p=CONFORMER_HEAVY_SHARES)
    n_h = np.full(h, (n - h) // h)
    n_h[rng.permutation(h)[: (n - h) % h]] += 1     # n - h <= 2h hydrogens
    types = np.concatenate([heavy, np.ones(n - h, np.int64)]).astype(np.int32)
    pos = np.zeros((n, 3))
    bonds = []
    for i in range(1, h):
        j = int(rng.integers(0, i))
        pos[i] = _place(rng, pos[:i], j, 1.5)
        bonds.append((j, i, 2 if rng.random() < 0.2 else 1))
    k = h
    for i in range(h):
        for _ in range(int(n_h[i])):
            pos[k] = _place(rng, pos[:k], i, 1.09)
            bonds.append((i, k, 1))
            k += 1
    row = [a for a, b, _ in bonds] + [b for a, b, _ in bonds]
    col = [b for a, b, _ in bonds] + [a for a, b, _ in bonds]
    code = [c for *_, c in bonds] * 2
    order = np.argsort(np.asarray(row) * n + np.asarray(col), kind="stable")
    return dict(
        atom_type=types,
        r_feat=np.zeros((n, 0), np.float32),
        p_feat=np.zeros((n, 0), np.float32),
        pos=(pos - pos.mean(axis=0)).astype(np.float32),
        edge_index=np.stack([np.asarray(row)[order], np.asarray(col)[order]]).astype(np.int32),
        edge_type=np.asarray(code, np.int32)[order],
        smiles=f"synthetic-conformer-{index}-{n}",
    )


def conformers_of(rng: np.random.Generator, mol: dict, k: int, scale: float = 0.15) -> list[dict]:
    """``k`` conformers of ``mol``: its geometry moved by N(0, ``scale``)
    per coordinate, rotated at random and centred."""
    out = []
    for _ in range(k):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        p = (np.asarray(mol["pos"], np.float64) + rng.normal(scale=scale, size=mol["pos"].shape)) @ q
        g = dict(mol)
        g["pos"] = (p - p.mean(axis=0)).astype(np.float32)
        out.append(g)
    return out


def make_conformer_corpus(n_molecules: int, seed: int, conformers: int = 5) -> list[dict]:
    """GeoDiff-legacy conformer graphs from ``np.random.default_rng(seed)``:
    ``conformers`` graphs per molecule, sharing its ``smiles``, in the
    schema of ``data/legacy.py`` (zero-width ``r_feat``/``p_feat``, plain
    bond codes as sparse ``edge_index``/``edge_type``).  Test data: the
    GEOM pickles and RDKit are not in the repository."""
    rng = np.random.default_rng(seed)
    graphs = []
    for i in range(n_molecules):
        graphs.extend(conformers_of(rng, make_molecule(rng, i), conformers))
    return graphs


def pdb_atom_line(serial, name, resname, chain, resnum, x, y, z, element) -> str:
    """One fixed-column ATOM record."""
    nm = f" {name:<3s}" if len(name) < 4 else name
    return (f"ATOM  {serial:>5d} {nm:<4s} {resname:<3s} {chain}{resnum:>4d}    "
            f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{0.0:6.2f}          {element:>2s}")


#: the gate's gamma atom per residue type: (name, element, bond length)
GATE_GAMMAS = {"SER": ("OG", "O", 1.42), "CYS": ("SG", "S", 1.81), "VAL": ("CG1", "C", 1.53)}
GATE_CYCLE = ("SER", "CYS", "VAL")


def res_chain(n_res: int, seed: int, chi1: float = -60.0, noise: float = 0.02) -> str:
    """The protein gate's synthetic chain (``tests/test_protein_gate.py::
    res_chain``): residues cycling SER/CYS/VAL along x, each chi1 at one
    rotamer (``chi1 = -60`` measures +60, gauche+), coordinates jittered by
    ``noise``."""
    from tsdiff_tpu_torch.eval.protein import place_dihedral

    rng = np.random.default_rng(seed)
    lines, serial = [], 1
    for r in range(1, n_res + 1):
        resname = GATE_CYCLE[(r - 1) % len(GATE_CYCLE)]
        base = np.array([3.5 * r, 0.0, 0.0])
        N = base
        CA = base + np.array([1.4, 0, 0.0])
        C = base + np.array([2.1, 1.2, 0.0])
        O = base + np.array([1.6, 2.3, 0.0])
        CB = place_dihedral(C, N, CA, 1.53, 110.5, 122.0)
        atoms = [("N", N, "N"), ("CA", CA, "C"), ("C", C, "C"), ("O", O, "O"), ("CB", CB, "C")]
        name, el, bond = GATE_GAMMAS[resname]
        atoms.append((name, place_dihedral(N, CA, CB, bond, 110.5, chi1), el))
        for name, xyz, el in atoms:
            xyz = xyz + rng.normal(scale=noise, size=3)
            lines.append(pdb_atom_line(serial, name, resname, "A", r, *xyz, el))
            serial += 1
    return "\n".join(lines) + "\nEND\n"


#: sidechain atoms past CB: (name, element, (a, b, c) placed from, bond,
#: angle, dihedral or a chi index); chi k takes the residue's k-th rotamer
_SIDECHAINS = {
    "ALA": (), "GLY": (),
    "SER": (("OG", "O", ("N", "CA", "CB"), 1.42, 110.5, 0),),
    "CYS": (("SG", "S", ("N", "CA", "CB"), 1.81, 113.8, 0),),
    "VAL": (("CG1", "C", ("N", "CA", "CB"), 1.53, 110.5, 0),
            ("CG2", "C", ("CG1", "CA", "CB"), 1.53, 110.5, 122.0)),
    "THR": (("OG1", "O", ("N", "CA", "CB"), 1.43, 109.5, 0),
            ("CG2", "C", ("OG1", "CA", "CB"), 1.52, 110.5, -120.0)),
    "LEU": (("CG", "C", ("N", "CA", "CB"), 1.53, 116.0, 0),
            ("CD1", "C", ("CA", "CB", "CG"), 1.52, 110.5, 1),
            ("CD2", "C", ("CD1", "CB", "CG"), 1.52, 110.5, 122.0)),
    "ILE": (("CG1", "C", ("N", "CA", "CB"), 1.53, 110.0, 0),
            ("CG2", "C", ("CG1", "CA", "CB"), 1.53, 110.5, -122.0),
            ("CD1", "C", ("CA", "CB", "CG1"), 1.52, 114.0, 1)),
    "ASP": (("CG", "C", ("N", "CA", "CB"), 1.52, 113.0, 0),
            ("OD1", "O", ("CA", "CB", "CG"), 1.25, 119.0, 1),
            ("OD2", "O", ("OD1", "CB", "CG"), 1.25, 119.0, 180.0)),
    "ASN": (("CG", "C", ("N", "CA", "CB"), 1.52, 113.0, 0),
            ("OD1", "O", ("CA", "CB", "CG"), 1.23, 121.0, 1),
            ("ND2", "N", ("OD1", "CB", "CG"), 1.33, 116.0, 180.0)),
    "GLU": (("CG", "C", ("N", "CA", "CB"), 1.52, 114.0, 0),
            ("CD", "C", ("CA", "CB", "CG"), 1.52, 113.0, 1),
            ("OE1", "O", ("CB", "CG", "CD"), 1.25, 119.0, 2),
            ("OE2", "O", ("OE1", "CG", "CD"), 1.25, 119.0, 180.0)),
    "GLN": (("CG", "C", ("N", "CA", "CB"), 1.52, 114.0, 0),
            ("CD", "C", ("CA", "CB", "CG"), 1.52, 113.0, 1),
            ("OE1", "O", ("CB", "CG", "CD"), 1.23, 121.0, 2),
            ("NE2", "N", ("OE1", "CG", "CD"), 1.33, 116.0, 180.0)),
    "MET": (("CG", "C", ("N", "CA", "CB"), 1.52, 114.0, 0),
            ("SD", "S", ("CA", "CB", "CG"), 1.81, 112.7, 1),
            ("CE", "C", ("CB", "CG", "SD"), 1.79, 100.5, 2)),
    "LYS": (("CG", "C", ("N", "CA", "CB"), 1.52, 114.0, 0),
            ("CD", "C", ("CA", "CB", "CG"), 1.52, 111.5, 1),
            ("CE", "C", ("CB", "CG", "CD"), 1.52, 111.5, 2),
            ("NZ", "N", ("CG", "CD", "CE"), 1.49, 111.7, 3)),
}
#: the residue types of ``compact_protein_pdb``, drawn uniformly
COMPACT_RESIDUES = tuple(sorted(_SIDECHAINS))
#: canonical rotamer wells of every chi (degrees)
ROTAMERS = (-60.0, 60.0, 180.0)


def compact_protein_pdb(n_res: int = 128, seed: int = 0, row: int = 8,
                        spacing: float = 6.0, noise: float = 0.05) -> str:
    """A compact synthetic protein as PDB text: ``n_res`` residues of
    random types (``COMPACT_RESIDUES``) in segments of ``row`` residues
    (CA steps of 3.8 A along x, back and forth), the segments ``spacing``
    apart on a square grid in y and z, so that there are about 137 cubic
    angstroms per residue, a real protein's density.  Consecutive residues
    of a segment are peptide-bonded; each segment is a chain break.  Each
    residue's N, C, O and CB are set about its CA, its sidechain built from
    ideal internal coordinates at rotamers drawn from ``ROTAMERS``
    (+-10 degrees), every atom jittered by ``noise``."""
    from tsdiff_tpu_torch.eval.protein import place_dihedral

    rng = np.random.default_rng(seed)
    n_rows = -(-n_res // row)
    side = int(np.ceil(np.sqrt(n_rows)))
    lines, serial = [], 1
    for r in range(n_res):
        seg, k = divmod(r, row)
        d = np.array([1.0 if seg % 2 == 0 else -1.0, 0.0, 0.0])
        e1, e2 = np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0])
        x0 = 0.0 if seg % 2 == 0 else 3.8 * (row - 1)
        ca = np.array([x0, spacing * (seg % side), spacing * (seg // side)]) + 3.8 * k * d
        resname = COMPACT_RESIDUES[rng.integers(len(COMPACT_RESIDUES))]
        atoms = {"N": ca - 1.2 * d + 0.8 * e1, "CA": ca, "C": ca + 1.2 * d + 0.85 * e1}
        atoms["O"] = atoms["C"] + 1.0 * e1 + 0.7 * d
        elements = {"N": "N", "CA": "C", "C": "C", "O": "O"}
        if resname != "GLY":
            up = 1.0 if k % 2 == 0 else -1.0  # alternate sides, as in a strand
            atoms["CB"] = ca - 0.5 * d - 0.9 * e1 + 1.2 * up * e2
            elements["CB"] = "C"
        chis = rng.choice(ROTAMERS, size=4) + rng.uniform(-10.0, 10.0, size=4)
        for name, el, (a, b, c), bond, angle, dih in _SIDECHAINS[resname]:
            dihedral = chis[dih] if isinstance(dih, int) else dih
            atoms[name] = place_dihedral(atoms[a], atoms[b], atoms[c], bond, angle, dihedral)
            elements[name] = el
        for name, xyz in atoms.items():
            xyz = xyz + rng.normal(scale=noise, size=3)
            lines.append(pdb_atom_line(serial, name, resname, "A", r + 1, *xyz, elements[name]))
            serial += 1
    return "\n".join(lines) + "\nEND\n"
