"""3D molecule visualization (reference utils/visualize.py:9-32).

Port of ``tsdiff_tpu/utils/visualize.py``: a py3Dmol stick-and-sphere viewer
for notebooks (py3Dmol imported where it is used), and a dependency-free xyz
dump for external viewers.
"""

from __future__ import annotations

import numpy as np

from tsdiff_tpu_torch.data.parse_xyz import format_xyz_block


def visualize_mol(atom_type, pos, size=(300, 300), surface=False, opacity=0.5):
    """py3Dmol viewer (requires py3Dmol, notebook context)."""
    import py3Dmol

    view = py3Dmol.view(width=size[0], height=size[1])
    view.addModel(format_xyz_block(np.asarray(atom_type), np.asarray(pos)), "xyz")
    view.setStyle({"stick": {}, "sphere": {"radius": 0.35}})
    if surface:
        view.addSurface(py3Dmol.SAS, {"opacity": opacity})
    view.zoomTo()
    return view


def write_xyz(path: str, atom_type, pos, comment: str = "", append: bool = False):
    with open(path, "a" if append else "w") as f:
        f.write(format_xyz_block(np.asarray(atom_type), np.asarray(pos), comment))
