"""Evaluation CLI: D-MAE of generated TS geometries against their references.

Usage:
    python -m tsdiff_tpu_torch.cli.evaluate --samples generated/samples_all.pkl \
        [--thresholds 0.1 0.2 0.3] [--no-automorphisms] [--out stats.pkl]

Port of ``tsdiff_tpu/cli/evaluate.py`` on the port's ``eval/dmae.py``: for
every sample with a generated geometry (``pos_gen``; a trajectory is scored on
its last frame) and a reference TS (``pos``, not all zero), the D-MAE under
the best automorphism match of the typed condensed graph (``--no-automorphisms``:
the identity only).  Prints the count, the mean, median and standard
deviation, and the fraction at or under each threshold; ``--out`` writes
``{"dmae": array, "thresholds": list}`` as a pickle.  ``--samples`` is the
sampling CLI's ``samples_all.pkl``, a ``tsdiff_tpu.v1`` dataset, or the
reference's PyG ``samples_all.pkl``.

``--covmat`` also scores the samples that carry a multi-conformer
``pos_ref`` stack and their generated ``pos_gen`` stack with the COV/MAT
evaluator (``eval/covmat.py``, one worker), prints its table and adds
``"covmat"`` (a ``CovMatResults``) to the stats.

``--protein`` reads a ``protein_sampling`` results pickle instead and
reports, over the covered sidechain atoms of each protein, the sidechain
RMSD (mean, median, standard deviation) and the chi1 accuracy at 40 degrees
over every measurable chi1 (``eval/protein.py``); ``--out`` writes
``{"sidechain_rmsd", "nan_flagged", "chi1_accuracy", "chi1_n"}``.  Numpy
only: nothing runs on a device.
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--samples", type=str, required=True)
    parser.add_argument("--thresholds", type=float, nargs="+", default=[0.1, 0.2, 0.3])
    parser.add_argument("--no-automorphisms", action="store_true")
    parser.add_argument("--covmat", action="store_true",
                        help="run the COV/MAT conformer-ensemble evaluator")
    parser.add_argument("--protein", action="store_true",
                        help="samples are protein_sampling results: report sidechain RMSD "
                             "and chi1 accuracy instead of D-MAE")
    parser.add_argument("--out", type=str, default=None, help="write stats pickle here")
    args = parser.parse_args(argv)

    from tsdiff_tpu_torch.data.dataset import load_dataset
    from tsdiff_tpu_torch.eval.dmae import dmae_for_graph

    try:
        samples, _ = load_dataset(args.samples)
    except ValueError:
        with open(args.samples, "rb") as f:
            samples = pickle.load(f)
    if args.protein:
        return _protein_stats(samples, args.out)

    dmaes = []
    skipped = 0
    for g in samples:
        if "pos_gen" not in g or g.get("pos") is None or not np.any(g["pos"]):
            skipped += 1
            continue
        pos_gen = np.asarray(g["pos_gen"])
        if pos_gen.ndim == 3:  # trajectory: final frame
            pos_gen = pos_gen[-1]
        dmaes.append(dmae_for_graph(g, pos_gen, use_automorphisms=not args.no_automorphisms))
    dmaes = np.asarray(dmaes)

    print(f"{len(dmaes)} samples evaluated ({skipped} skipped, no reference pos)")
    if len(dmaes):
        print(f"D-MAE  mean {dmaes.mean():.4f} | median {np.median(dmaes):.4f} | "
              f"std {dmaes.std():.4f}")
        for t in args.thresholds:
            print(f"  fraction with D-MAE <= {t:.2f}: {(dmaes <= t).mean():.3f}")

    stats = {"dmae": dmaes, "thresholds": args.thresholds}
    if args.covmat:
        from tsdiff_tpu_torch.eval.covmat import CovMatEvaluator, print_covmat_results

        packed = [g for g in samples if "pos_ref" in g and "pos_gen" in g]
        if packed:
            res = CovMatEvaluator(num_workers=1)(packed)
            print_covmat_results(res)
            stats["covmat"] = res
        else:
            print("no multi-conformer samples with pos_ref; skipping COV/MAT")
    _write_stats(stats, args.out)
    return stats


def _write_stats(stats: dict, out: str | None) -> None:
    if out:
        with open(out, "wb") as f:
            pickle.dump(stats, f)


def _protein_stats(samples, out: str | None) -> dict:
    """Sidechain RMSD and chi1 accuracy over a ``protein_sampling`` results
    pickle (``tsdiff_tpu/cli/evaluate.py:97-134``)."""
    from tsdiff_tpu_torch.eval.protein import chi1_accuracy

    rmsds, uncovered, nans = [], 0, 0
    chi1_hits, chi1_total = 0.0, 0
    for r in samples:
        nans += bool(r.get("nan"))
        sc = np.asarray(r["is_sidechain"], bool)
        cov = np.asarray(r["coverage_counts"])[sc] > 0
        if not cov.any():
            uncovered += 1
            continue
        d = np.asarray(r["pos_gen"])[sc][cov] - np.asarray(r["pos_gt"])[sc][cov]
        rmsds.append(float(np.sqrt((d ** 2).sum(-1).mean())))
        if "atom_name" in r:
            acc, n_ang = chi1_accuracy(r["pos_gen"], r["pos_gt"], r,
                                       coverage_counts=r.get("coverage_counts"))
            if n_ang:
                chi1_hits += acc * n_ang
                chi1_total += n_ang
    rmsds = np.asarray(rmsds)
    print(f"{len(rmsds)} proteins evaluated ({uncovered} with no covered "
          f"sidechains, {nans} NaN-flagged)")
    if len(rmsds):
        print(f"sidechain RMSD  mean {rmsds.mean():.4f} | median "
              f"{np.median(rmsds):.4f} | std {rmsds.std():.4f}")
    chi1 = chi1_hits / chi1_total if chi1_total else float("nan")
    if chi1_total:
        print(f"chi1 accuracy (40 deg): {chi1:.3f} over {chi1_total} angles")
    stats = {"sidechain_rmsd": rmsds, "nan_flagged": nans,
             "chi1_accuracy": chi1, "chi1_n": chi1_total}
    _write_stats(stats, out)
    return stats


if __name__ == "__main__":
    main()
