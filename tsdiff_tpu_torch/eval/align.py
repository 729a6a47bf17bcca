"""Rigid alignment in numpy: Kabsch rotation and translation, and the
better of a geometry and its mirror image."""

from __future__ import annotations

import numpy as np

MIRROR = np.diag([1.0, 1.0, -1.0])


def kabsch_align(ref: np.ndarray, prb: np.ndarray) -> np.ndarray:
    """``prb`` rotated and translated onto ``ref`` (least-squares RMSD,
    proper rotations only)."""
    ref_c = ref - ref.mean(axis=0)
    prb_c = prb - prb.mean(axis=0)
    h = prb_c.T @ ref_c
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(u @ vt))
    rot = u @ np.diag([1.0, 1.0, d]) @ vt
    return prb_c @ rot + ref.mean(axis=0)


def rmsd(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(((a - b) ** 2).sum(axis=1).mean()))


def rotate_transform_mirror(ref: np.ndarray, prb: np.ndarray) -> np.ndarray:
    """``prb`` aligned to ``ref``, or its mirror image aligned, whichever
    lies closer: the distance-based model does not see chirality."""
    p1 = kabsch_align(ref, prb)
    p2 = kabsch_align(ref, prb @ MIRROR)
    return p1 if rmsd(p1, ref) <= rmsd(p2, ref) else p2


def position_align(ref: np.ndarray, pos_list: list[np.ndarray]) -> list[np.ndarray]:
    return [rotate_transform_mirror(ref, p) for p in pos_list]
