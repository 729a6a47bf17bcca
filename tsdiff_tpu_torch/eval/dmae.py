"""D-MAE — the TS-accuracy metric: mean absolute difference of the
strict-upper-triangle interatomic distance matrices of two conformations.
Automorphism matching is not ported yet."""

from __future__ import annotations

import numpy as np


def distance_matrix(pos: np.ndarray) -> np.ndarray:
    return np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)


def calc_dmae(pos_ref: np.ndarray, pos_gen: np.ndarray, mapping=None) -> float:
    """Mean |d_ref - d_gen| over the strict upper triangle; ``mapping``
    permutes pos_gen."""
    d_ref = distance_matrix(pos_ref)
    pg = pos_gen[np.asarray(mapping)] if mapping is not None else pos_gen
    d_gen = distance_matrix(pg)
    iu = np.triu_indices(len(pos_ref), k=1)
    return float(np.abs(d_ref[iu] - d_gen[iu]).mean())
