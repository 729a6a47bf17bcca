"""COV/MAT of generated conformer ensembles.

For each molecule, the best-RMSD matrix between its reference conformers
(``pos_ref``) and its generated ones (``pos_gen``), reduced to COV-R / MAT-R
(each reference conformer should lie near some generated one) and COV-P /
MAT-P (each generated conformer near some reference one) over a grid of
thresholds.

The best RMSD is the numpy one: heavy atoms only (atom type != 1), the
Kabsch alignment with and without mirror, minimised over the automorphisms
of the heavy-atom bond graph.  A molecule that carries an RDKit ``rdmol``
takes RDKit's ``GetBestRMS`` instead (``utils/chem_rdkit.py``), each
generated conformer first relaxed with MMFF under ``use_ff``, as the JAX
package's does.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from functools import partial

import numpy as np

from tsdiff_tpu_torch.eval.align import MIRROR, kabsch_align
from tsdiff_tpu_torch.eval.dmae import graph_automorphisms


def best_rmsd_numpy(pos_gen: np.ndarray, pos_ref: np.ndarray, matches: list | None = None,
                    heavy_mask: np.ndarray | None = None) -> float:
    """Smallest aligned RMSD over the matches, each with and without mirror."""
    if heavy_mask is not None:
        pos_gen_h = pos_gen[heavy_mask]
        pos_ref_h = pos_ref[heavy_mask]
    else:
        pos_gen_h, pos_ref_h = pos_gen, pos_ref
    if matches is None:
        matches = [np.arange(len(pos_gen_h))]
    best = np.inf
    for m in matches:
        pg = pos_gen_h[np.asarray(m)]
        for p in (pg, pg @ MIRROR):
            aligned = kabsch_align(pos_ref_h, p)
            v = float(np.sqrt(((aligned - pos_ref_h) ** 2).sum(-1).mean()))
            best = min(best, v)
    return best


def rmsd_confusion_matrix(data: dict, use_ff: bool = False) -> np.ndarray:
    """(num_ref, num_gen) best-RMSD matrix of one molecule: ``pos_ref``
    (R, n, 3), ``pos_gen`` (G, n, 3), ``atom_type`` and optionally
    ``edge_index``/``edge_type`` for the automorphisms."""
    pos_ref = np.asarray(data["pos_ref"], dtype=np.float64)
    pos_gen = np.asarray(data["pos_gen"], dtype=np.float64)
    n = pos_ref.shape[-2]
    pos_ref = pos_ref.reshape(-1, n, 3)
    pos_gen = pos_gen.reshape(-1, n, 3)
    num_ref, num_gen = pos_ref.shape[0], pos_gen.shape[0]

    rdmol = data.get("rdmol")
    if rdmol is not None:
        from rdkit.Chem.rdForceFieldHelpers import MMFFOptimizeMolecule

        from tsdiff_tpu_torch.utils.chem_rdkit import get_best_rmsd, set_rdmol_positions

        mat = np.empty((num_ref, num_gen))
        for i in range(num_gen):
            gen_mol = set_rdmol_positions(rdmol, pos_gen[i])
            if use_ff:
                MMFFOptimizeMolecule(gen_mol)
            for j in range(num_ref):
                ref_mol = set_rdmol_positions(rdmol, pos_ref[j])
                mat[j, i] = get_best_rmsd(gen_mol, ref_mol)
        return mat

    # heavy atoms only, as RDKit's RemoveHs; automorphisms of their bond graph
    atom_type = np.asarray(data["atom_type"])
    heavy = atom_type != 1
    matches = None
    if "edge_index" in data:
        bond = np.zeros((n, n), dtype=np.int64)
        ei = np.asarray(data["edge_index"])
        bond[ei[0], ei[1]] = np.asarray(data["edge_type"])
        hidx = np.where(heavy)[0]
        matches = graph_automorphisms(bond[np.ix_(hidx, hidx)], atom_type[hidx])
    mat = np.empty((num_ref, num_gen))
    for i in range(num_gen):
        for j in range(num_ref):
            mat[j, i] = best_rmsd_numpy(pos_gen[i][heavy], pos_ref[j][heavy], matches=matches)
    return mat


def evaluate_conf(data: dict, use_ff: bool = False, threshold: float = 0.5):
    """(coverage at ``threshold``, mean best RMSD) of one molecule."""
    mat = rmsd_confusion_matrix(data, use_ff=use_ff)
    ref_min = mat.min(-1)
    return float((ref_min <= threshold).mean()), float(ref_min.mean())


@dataclasses.dataclass
class CovMatResults:
    CoverageR: np.ndarray  # (num_mols, num_thres)
    MatchingR: np.ndarray  # (num_mols,)
    CoverageP: np.ndarray
    MatchingP: np.ndarray
    thresholds: np.ndarray


class CovMatEvaluator:
    """COV/MAT over a list of molecules, each with ``pos_ref`` and at least
    ``ratio`` times as many generated conformers in ``pos_gen`` (the first
    ``ratio x R`` are scored); disconnected SMILES (with ".") are skipped
    unless ``filter_disconnected`` is False.  ``num_workers > 1`` scores
    the molecules in a pool of spawned processes (a fork of a process that
    runs torch's threads may deadlock)."""

    def __init__(self, num_workers: int = 8, use_force_field: bool = False,
                 thresholds=np.arange(0.05, 3.05, 0.05), ratio: int = 2,
                 filter_disconnected: bool = True, print_fn=print):
        self.num_workers = num_workers
        self.use_force_field = use_force_field
        self.thresholds = np.asarray(thresholds).flatten()
        self.ratio = ratio
        self.filter_disconnected = filter_disconnected
        self.print_fn = print_fn

    def __call__(self, packed_data_list, start_idx: int = 0) -> CovMatResults:
        filtered = []
        for data in packed_data_list:
            if "pos_gen" not in data or "pos_ref" not in data:
                continue
            if self.filter_disconnected and "." in data.get("smiles", ""):
                continue
            n = np.asarray(data["atom_type"]).shape[0]
            data = dict(data)
            data["pos_ref"] = np.asarray(data["pos_ref"]).reshape(-1, n, 3)
            data["pos_gen"] = np.asarray(data["pos_gen"]).reshape(-1, n, 3)
            num_gen = data["pos_ref"].shape[0] * self.ratio
            if data["pos_gen"].shape[0] < num_gen:
                continue
            data["pos_gen"] = data["pos_gen"][:num_gen]
            filtered.append(data)
        filtered = filtered[start_idx:]
        self.print_fn(f"Filtered: {len(filtered)} / {len(packed_data_list)}")

        func = partial(rmsd_confusion_matrix, use_ff=self.use_force_field)
        if self.num_workers > 1:
            with ProcessPoolExecutor(self.num_workers,
                                     mp_context=multiprocessing.get_context("spawn")) as pool:
                mats = list(pool.map(func, filtered))
        else:
            mats = [func(d) for d in filtered]

        covr, matr, covp, matp = [], [], [], []
        for mat in mats:
            ref_min = mat.min(-1)
            gen_min = mat.min(0)
            covr.append((ref_min[:, None] <= self.thresholds[None]).mean(0, keepdims=True))
            covp.append((gen_min[:, None] <= self.thresholds[None]).mean(0, keepdims=True))
            matr.append(ref_min.mean())
            matp.append(gen_min.mean())

        return CovMatResults(
            CoverageR=np.vstack(covr),
            MatchingR=np.array(matr),
            CoverageP=np.vstack(covp),
            MatchingP=np.array(matp),
            thresholds=self.thresholds,
        )


def print_covmat_results(results: CovMatResults, print_fn=print):
    """Coverage by threshold (mean and median over molecules), then MAT-R
    and MAT-P, as plain text."""
    header = (f"{'thresh':>8} {'COV-R_mean':>12} {'COV-R_med':>12} "
              f"{'COV-P_mean':>12} {'COV-P_med':>12}")
    lines = [header]
    for k, t in enumerate(results.thresholds):
        lines.append(
            f"{t:>8.2f} {results.CoverageR[:, k].mean():>12.4f} "
            f"{np.median(results.CoverageR[:, k]):>12.4f} "
            f"{results.CoverageP[:, k].mean():>12.4f} "
            f"{np.median(results.CoverageP[:, k]):>12.4f}"
        )
    print_fn("\n".join(lines))
    print_fn(
        "MAT-R_mean: %.4f | MAT-R_median: %.4f | MAT-R_std %.4f"
        % (results.MatchingR.mean(), np.median(results.MatchingR), results.MatchingR.std())
    )
    print_fn(
        "MAT-P_mean: %.4f | MAT-P_median: %.4f | MAT-P_std %.4f"
        % (results.MatchingP.mean(), np.median(results.MatchingP), results.MatchingP.std())
    )
