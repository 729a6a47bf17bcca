"""Dataset-build CLI: the reference's preprocessing.py workflow.

Usage:
    python -m tsdiff_tpu_torch.cli.preprocessing --ts_data wb97xd3_ts.xyz \
        --rxn_smarts_file wb97xd3_fwd_rev_chemprop.csv --save_dir OUT

Parses the Grambow wb97xd3 corpus (TS xyz blocks + atom-mapped fwd/rev
reaction-SMARTS CSV) into ``tsdiff_tpu.v1`` datasets, one-hot encodes atom
features (feat_dim 25 in production), and writes the deterministic
fwd/rev-paired 80/10/10 split (seed 42, banned indices [20568, 20569, 20580,
20581]), as ``tsdiff_tpu/cli/preprocessing.py`` does: ``train_data.pkl``,
``valid_data.pkl``, ``test_data.pkl``, ``feat_dict.pkl`` and
``index_dict.pkl``.  Needs RDKit; numpy otherwise, nothing runs on a device.
The ``--pdb_glob`` protein branch is not ported (ROADMAP §A.7c).
"""

from __future__ import annotations

import argparse
import csv
import os
import pickle


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--train", type=float, default=0.8)
    parser.add_argument("--valid", type=float, default=0.1)
    parser.add_argument("--feat_dict", type=str, default="data/TS/wb97xd3/feat_dict.pkl")
    parser.add_argument("--save_dir", type=str, default="data/TS/wb97xd3/random_split_42")
    parser.add_argument("--ts_data", type=str, default="data/TS/wb97xd3/raw_data/wb97xd3_ts.xyz")
    parser.add_argument("--rxn_smarts_file", type=str,
                        default="data/TS/wb97xd3/raw_data/wb97xd3_fwd_rev_chemprop.csv")
    parser.add_argument("--smarts_column", type=str, default="AAM")
    parser.add_argument("--ban_index", type=int, nargs="+", default=[20568, 20569, 20580, 20581])
    parser.add_argument("--pdb_glob", type=str, default=None,
                        help="protein mode: not ported (ROADMAP §A.7c)")
    args = parser.parse_args(argv)
    if args.pdb_glob:
        raise NotImplementedError("--pdb_glob (the protein dataset) is not yet ported "
                                  "(ROADMAP §A.7c)")

    from tsdiff_tpu_torch.data.dataset import save_dataset
    from tsdiff_tpu_torch.data.featurize import (
        default_feat_dict,
        generate_ts_data,
        one_hot_features,
    )
    from tsdiff_tpu_torch.data.parse_xyz import parse_xyz_corpus
    from tsdiff_tpu_torch.data.splits import index_split

    xyz_blocks = parse_xyz_corpus(args.ts_data)
    with open(args.rxn_smarts_file) as f:
        rows = list(csv.DictReader(f))
    rxn_smarts = [row[args.smarts_column] for row in rows]

    ban_index = args.ban_index if args.ban_index and args.ban_index[0] != -1 else []

    if os.path.isfile(args.feat_dict):
        with open(args.feat_dict, "rb") as f:
            feat_dict = pickle.load(f)
    else:
        print(f"{args.feat_dict} does not exist; using default feat_dict.")
        feat_dict = default_feat_dict()

    graphs = []
    for idx, (smarts, xyz) in enumerate(zip(rxn_smarts, xyz_blocks)):
        r, p = smarts.split(">>")
        g, feat_dict = generate_ts_data(r, p, xyz, feat_dict=feat_dict)
        g["rxn_index"] = idx // 2
        g["augmented"] = idx % 2 == 1
        graphs.append(g)

    graphs = one_hot_features(graphs, feat_dict)

    train_ix, valid_ix, test_ix = index_split(
        len(graphs) // 2, train=args.train, valid=args.valid, seed=args.seed
    )
    train_ix = [i for i in train_ix if i not in ban_index]
    valid_ix = [i for i in valid_ix if i not in ban_index]
    test_ix = [i for i in test_ix if i not in ban_index]

    os.makedirs(args.save_dir, exist_ok=True)
    for name, ix in (("train", train_ix), ("valid", valid_ix), ("test", test_ix)):
        save_dataset(
            os.path.join(args.save_dir, f"{name}_data.pkl"),
            [graphs[i] for i in ix],
            feat_dict=feat_dict,
        )
    with open(os.path.join(args.save_dir, "feat_dict.pkl"), "wb") as f:
        pickle.dump(feat_dict, f)
    with open(os.path.join(args.save_dir, "index_dict.pkl"), "wb") as f:
        pickle.dump(
            {"train_index": train_ix, "valid_index": valid_ix, "test_index": test_ix}, f
        )
    print(
        f"Wrote {len(train_ix)}/{len(valid_ix)}/{len(test_ix)} train/valid/test "
        f"graphs to {args.save_dir} (feat_dim="
        f"{sum(len(v) for v in feat_dict.values())})"
    )


if __name__ == "__main__":
    main()
