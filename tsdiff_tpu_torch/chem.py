"""Chemistry constants of the condensed reaction graph.

The bond-type vocabulary is RDKit's ``BondType`` enum in value order (22
names).  The condensed edge code is ``r_type * NUM_BOND_TYPES + p_type`` with
0 = no bond, and a k-hop (k >= 2) edge of the order extension gets type
``NUM_BOND_TYPES + k - 1``.  RDKit is needed only to featurize SMARTS
(``data/featurize.py``), where it is imported; ``have_rdkit`` probes for it.
"""

from __future__ import annotations

# RDKit Chem.rdchem.BondType names in enum-value order.
BOND_TYPE_NAMES = (
    "UNSPECIFIED", "SINGLE", "DOUBLE", "TRIPLE", "QUADRUPLE", "QUINTUPLE",
    "HEXTUPLE", "ONEANDAHALF", "TWOANDAHALF", "THREEANDAHALF", "FOURANDAHALF",
    "FIVEANDAHALF", "AROMATIC", "IONIC", "HYDROGEN", "THREECENTER",
    "DATIVEONE", "DATIVE", "DATIVEL", "DATIVER", "OTHER", "ZERO",
)

#: Number of bond types — the base of the condensed edge encoding (== 22).
NUM_BOND_TYPES = len(BOND_TYPE_NAMES)

#: name -> code (the reference's ``BOND_TYPES``, keyed by enum value)
BOND_TYPES = {name: i for i, name in enumerate(BOND_TYPE_NAMES)}


def bond_code_from_rdkit(bond_type) -> int:
    """The integer code of an RDKit ``BondType`` enum member."""
    return int(bond_type)


def have_rdkit() -> bool:
    """RDKit imports, and is not the PyG-unpickle stand-in
    (``data/pyg_compat.py``)."""
    try:
        import rdkit
    except ImportError:
        return False
    return not getattr(rdkit, "__tsdiff_tpu_stub__", False)
