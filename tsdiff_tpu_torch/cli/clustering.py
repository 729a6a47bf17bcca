"""Conformer-clustering CLI.

Usage:
    python -m tsdiff_tpu_torch.cli.clustering --sample_path samples_all.pkl \
        [--thresh 0.10 --sample_index 0 --save_dir clustering --force]

Takes every generated conformer of one reaction (the ``smiles`` of sample
``--sample_index``) from a samples pickle, the last frame of a saved
trajectory, and clusters them by single linkage under the
automorphism-aware distance-matrix metric (``eval/clustering.py``; the
automorphisms from RDKit's substructure matches where it is installed, else
from the graph).  Writes ``hierarchy_clustering.png`` (a dendrogram, skipped
when matplotlib does not import), ``stat_clustering.pkl`` (``num_clusters``,
``cluster`` labels, ``dist_mat``) and one ``cluster_<i>.xyz`` per cluster,
its members renumbered by their best match and aligned to its first.
Numpy and scipy only: nothing runs on a device.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def main(argv=None) -> str:
    """Cluster; returns the save directory."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--thresh", type=float, default=0.10)
    parser.add_argument("--sample_index", type=int, default=0)
    parser.add_argument("--save_dir", type=str, default="clustering")
    parser.add_argument("--sample_path", type=str, default="generated/samples_all.pkl")
    parser.add_argument("--num_levels", type=int, default=3)
    parser.add_argument("--force", action="store_true")
    args = parser.parse_args(argv)

    from tsdiff_tpu_torch.chem import have_rdkit
    from tsdiff_tpu_torch.data.parse_xyz import format_xyz_block
    from tsdiff_tpu_torch.eval.clustering import align_cluster, cluster_conformers, matches_for

    with open(args.sample_path, "rb") as f:
        gen_data = pickle.load(f)
    smarts = gen_data[args.sample_index]["smiles"]
    gen_data = [g for g in gen_data if g.get("smiles") == smarts]

    pos_list, atom_type = [], None
    for g in gen_data:
        pos = np.asarray(g["pos_gen"])
        if pos.ndim == 3:  # trajectory saved: take the final frame
            pos = pos[-1]
        pos_list.append(np.asarray(pos, dtype=np.float64))
        atom_type = np.asarray(g["atom_type"])
    print(f"{len(pos_list)} conformers of {smarts}")

    matches = matches_for(smarts if have_rdkit() else gen_data[0])
    print(f"{len(matches)} automorphism matches")

    print("start clustering")
    stat = cluster_conformers(pos_list, matches, thresh=args.thresh)
    clusters = stat["clusters"]
    print(f"{stat['num_clusters']} clusters at thresh {args.thresh}")

    if os.path.isdir(args.save_dir):
        if not args.force:
            raise ValueError(f"{args.save_dir} already exists. Use --force to overwrite.")
        import shutil

        shutil.rmtree(args.save_dir)
    os.makedirs(args.save_dir, exist_ok=True)

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from scipy.cluster.hierarchy import dendrogram

        fig, ax = plt.subplots(figsize=(10, 10))
        dendrogram(
            stat["linkage"],
            args.num_levels,
            truncate_mode="level",
            color_threshold=args.thresh,
            orientation="top",
            distance_sort="descending",
            show_leaf_counts=True,
            above_threshold_color="k",
            ax=ax,
        )
        ax.axhline(args.thresh, color="k", linestyle="--", alpha=0.7)
        fig.savefig(os.path.join(args.save_dir, "hierarchy_clustering.png"))
        plt.close(fig)
    except ImportError:
        print("matplotlib unavailable; skipping dendrogram plot")

    with open(os.path.join(args.save_dir, "stat_clustering.pkl"), "wb") as f:
        pickle.dump({"num_clusters": stat["num_clusters"], "cluster": clusters,
                     "dist_mat": stat["dist_mat"]}, f)

    print("start converting xyz for saving")
    for i in range(1, stat["num_clusters"] + 1):
        members = [pos_list[j] for j in np.where(clusters == i)[0]]
        aligned = align_cluster(members, matches, ref=members[0])
        with open(os.path.join(args.save_dir, f"cluster_{i}.xyz"), "a") as f:
            for pos in aligned:
                f.write(format_xyz_block(atom_type, pos, comment=f"cluster {i}"))
    return args.save_dir


if __name__ == "__main__":
    main()
