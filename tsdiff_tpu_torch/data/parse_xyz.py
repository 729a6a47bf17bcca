"""xyz-format parsing (host-side).

Equivalent of reference utils/parse_xyz.py:2-48: parse single xyz files,
xyz blocks, and corpus files (concatenated xyz blocks).  Whitespace-tolerant
(the reference has two diverging copies: tab-separated in utils/datasets.py:
388-404, generic split in utils/parse_xyz.py — one implementation here).
"""

from __future__ import annotations

import numpy as np

# atomic symbol -> number for elements in reaction datasets (H..Ar covers
# wb97xd3: C, H, N, O; extended for safety)
ATOMIC_NUMBERS = {
    "H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7, "O": 8,
    "F": 9, "Ne": 10, "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15,
    "S": 16, "Cl": 17, "Ar": 18, "K": 19, "Ca": 20, "Br": 35, "I": 53,
}
ATOMIC_SYMBOLS = {v: k for k, v in ATOMIC_NUMBERS.items()}


def read_xyz_block(block: str) -> tuple[np.ndarray, np.ndarray]:
    """One xyz block (count line, comment line, atom lines) -> (symbols, pos)."""
    lines = [ln for ln in block.split("\n")]
    natoms = int(lines[0].split()[0])
    atom_lines = [ln for ln in lines[2:] if ln.strip()][:natoms]
    symbols, pos = [], []
    for ln in atom_lines:
        parts = ln.split()
        symbols.append(parts[0])
        pos.append([float(x) for x in parts[1:4]])
    return np.array(symbols), np.array(pos, dtype=np.float64)


def parse_xyz_file(path: str) -> tuple[np.ndarray, np.ndarray]:
    with open(path) as f:
        return read_xyz_block(f.read())


def parse_xyz_corpus(path: str) -> list[str]:
    """Split a concatenated-xyz corpus into blocks (reference parse_xyz.py:29-48)."""
    with open(path) as f:
        lines = f.read().split("\n")
    blocks = []
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        n = int(lines[i].split()[0])
        blocks.append("\n".join(lines[i : i + n + 2]))
        i += n + 2
    return blocks


def format_xyz_block(symbols, pos, comment: str = "") -> str:
    """(n,) symbols or atomic numbers + (n,3) coords -> xyz block string."""
    out = [str(len(symbols)), comment]
    for s, p in zip(symbols, pos):
        sym = ATOMIC_SYMBOLS[int(s)] if not isinstance(s, str) else s
        out.append(f"{sym} {p[0]:.8f} {p[1]:.8f} {p[2]:.8f}")
    return "\n".join(out) + "\n"
