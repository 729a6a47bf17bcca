"""Protein sidechain evaluation: chi1 dihedral accuracy.

The standard sidechain-packing metric (beyond raw RMSD): the chi1 torsion
N-CA-CB-G (G = first gamma atom; CG / CG1 for ILE & VAL / OG for SER / OG1
for THR / SG for CYS) of the generated conformation is "correct" when within
a tolerance (conventionally 40 degrees) of the reference.  ALA/GLY have no
chi1.  Port of the JAX package's ``eval/protein.py``, numpy only; graphs are
the dicts of ``data/pdb.py`` (identity columns ``atom_name``/``res_name``/
``atom2res`` required).
"""

from __future__ import annotations

import numpy as np

#: first gamma atom per residue type (standard PDB v3 names)
GAMMA_ATOM = {
    "ARG": "CG", "ASN": "CG", "ASP": "CG", "CYS": "SG", "GLN": "CG",
    "GLU": "CG", "HIS": "CG", "ILE": "CG1", "LEU": "CG", "LYS": "CG",
    "MET": "CG", "PHE": "CG", "PRO": "CG", "SER": "OG", "THR": "OG1",
    "TRP": "CG", "TYR": "CG", "VAL": "CG1",
}


def place_dihedral(
    a: np.ndarray, b: np.ndarray, c: np.ndarray,
    bond: float, angle_deg: float, dih_deg: float,
) -> np.ndarray:
    """NeRF placement: the position of atom d given the a-b-c frame with
    |c-d| = ``bond``, angle(b,c,d) = ``angle_deg`` and dihedral(a,b,c,d) =
    ``dih_deg``.  Standard internal-coordinate reconstruction; used by the
    template-rotamer baseline in the protein quality gate (build a sidechain
    gamma atom at a canonical chi1 from the backbone frame)."""
    a, b, c = (np.asarray(x, float) for x in (a, b, c))
    bc = c - b
    bc = bc / np.linalg.norm(bc)
    n = np.cross(b - a, bc)
    n = n / np.linalg.norm(n)
    m = np.cross(n, bc)
    ang = np.radians(180.0 - angle_deg)
    dih = np.radians(dih_deg)
    d2 = bond * np.array(
        [np.cos(ang), np.sin(ang) * np.cos(dih), np.sin(ang) * np.sin(dih)]
    )
    return c + d2[0] * bc + d2[1] * m + d2[2] * n


def chi1_quads(graph: dict) -> np.ndarray:
    """(n_chi, 4) atom indices [N, CA, CB, G] for every residue with a chi1.

    Residues missing any of the four atoms are skipped.
    """
    atom2res = np.asarray(graph["atom2res"])
    names = graph["atom_name"]
    resnames = graph["res_name"]
    by_res: dict[int, dict[str, int]] = {}
    for i, r in enumerate(atom2res):
        by_res.setdefault(int(r), {}).setdefault(names[i], i)
    quads = []
    for r, atoms in sorted(by_res.items()):
        i0 = min(atoms.values())
        gamma = GAMMA_ATOM.get(resnames[i0])
        if gamma is None:
            continue
        try:
            quads.append([atoms["N"], atoms["CA"], atoms["CB"], atoms[gamma]])
        except KeyError:
            continue
    return np.asarray(quads, np.int64).reshape(-1, 4)


def dihedral_deg(pos: np.ndarray, quads: np.ndarray) -> np.ndarray:
    """Signed dihedral angles (degrees) for (m, 4) atom-index quadruples.

    Standard atan2 formulation (numerically stable near 0/180; matches the
    sign convention of reference models/geometry.py get_dihedral).
    """
    p = np.asarray(pos, np.float64)
    a, b, c, d = (p[quads[:, k]] for k in range(4))
    b1, b2, b3 = b - a, c - b, d - c
    n1 = np.cross(b1, b2)
    n2 = np.cross(b2, b3)
    m1 = np.cross(n1, b2 / np.linalg.norm(b2, axis=-1, keepdims=True))
    x = np.sum(n1 * n2, axis=-1)
    y = np.sum(m1 * n2, axis=-1)
    return np.degrees(np.arctan2(y, x))


def angular_diff_deg(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| on the circle, in [0, 180]."""
    d = np.abs(a - b) % 360.0
    return np.minimum(d, 360.0 - d)


#: canonical chi1 rotamer wells (degrees): gauche+, trans, gauche-
ROTAMER_WELLS = {"g+": 60.0, "t": 180.0, "g-": -60.0}


def rotamer_distribution(
    pos: np.ndarray, graph: dict,
    coverage_counts: np.ndarray | None = None,
) -> dict:
    """chi1 rotamer-well occupancy + circular concentration statistics.

    Sidechain packing cares about which WELL each chi1 lands in, not just
    a pointwise tolerance (chi1_accuracy): the standard rotamer summary is
    the g+/t/g- occupancy histogram (nearest canonical well on the circle)
    plus the circular mean/resultant of the angles.  Returns
    ``{"n", "wells": {g+,t,g-}, "circ_mean_deg", "circ_R"}`` where circ_R
    in [0,1] is the mean-resultant length (1 = all angles identical — a
    model that LEARNED one corpus rotamer concentrates; random geometry
    gives R near 0 and a ~uniform well histogram).
    """
    quads = chi1_quads(graph)
    if coverage_counts is not None and len(quads):
        cov = np.asarray(coverage_counts)
        quads = quads[(cov[quads[:, 2]] > 0) & (cov[quads[:, 3]] > 0)]
    if len(quads) == 0:
        return {"n": 0, "wells": {k: float("nan") for k in ROTAMER_WELLS},
                "circ_mean_deg": float("nan"), "circ_R": float("nan")}
    chi = dihedral_deg(pos, quads)
    names = list(ROTAMER_WELLS)
    centers = np.array([ROTAMER_WELLS[k] for k in names])
    dist = angular_diff_deg(chi[:, None], centers[None, :])  # (n, 3)
    nearest = np.argmin(dist, axis=1)
    wells = {k: float(np.mean(nearest == i)) for i, k in enumerate(names)}
    rad = np.radians(chi)
    z = np.exp(1j * rad).mean()
    return {
        "n": int(len(quads)),
        "wells": wells,
        "circ_mean_deg": float(np.degrees(np.angle(z))),
        "circ_R": float(np.abs(z)),
    }


def chi1_accuracy(
    pos_gen: np.ndarray, pos_gt: np.ndarray, graph: dict, tol_deg: float = 40.0,
    coverage_counts: np.ndarray | None = None,
) -> tuple[float, int]:
    """Fraction of chi1 angles within ``tol_deg`` of the reference.

    Returns ``(accuracy, n_angles)``; ``(nan, 0)`` when the protein has no
    measurable chi1 (e.g. ALA/GLY-only).

    ``coverage_counts`` (n,): when given, quads whose sidechain atoms (CB and
    the gamma atom) were never scored (count 0 — their pos_gen still equals
    the ground-truth input) are excluded so they cannot inflate accuracy.
    """
    quads = chi1_quads(graph)
    if coverage_counts is not None and len(quads):
        cov = np.asarray(coverage_counts)
        quads = quads[(cov[quads[:, 2]] > 0) & (cov[quads[:, 3]] > 0)]
    if len(quads) == 0:
        return float("nan"), 0
    diff = angular_diff_deg(
        dihedral_deg(pos_gen, quads), dihedral_deg(pos_gt, quads)
    )
    return float((diff <= tol_deg).mean()), int(len(quads))
