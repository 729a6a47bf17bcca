"""TS-guess injection CLI (reference utils/post_processing.py:8-133).

Attaches external coordinates (``ts_guess`` from a quick guess method, or
``pos_r``/``pos_p`` endpoint geometries) to a dataset pickle, so that
sampling can start from an approximate TS with ``--from_ts_guess
--denoise_from_time_t T [--noise_from_time_t S]`` (SDE editing of a guess
instead of generation from noise).  Numpy only.

Usage:
    python -m tsdiff_tpu_torch.cli.post_processing --data test_data.pkl \
        --xyz guesses.xyz --key ts_guess --out test_data_guess.pkl
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--data", type=str, required=True,
                        help="dataset pickle (tsdiff_tpu.v1 or reference PyG)")
    parser.add_argument("--xyz", type=str, required=True, help="xyz corpus, one block per reaction")
    parser.add_argument("--key", type=str, default="ts_guess",
                        choices=["ts_guess", "pos_r", "pos_p"])
    parser.add_argument("--out", type=str, required=True)
    args = parser.parse_args(argv)

    from tsdiff_tpu_torch.data.dataset import load_dataset, save_dataset
    from tsdiff_tpu_torch.data.parse_xyz import parse_xyz_corpus, read_xyz_block

    graphs, feat_dict = load_dataset(args.data)
    blocks = parse_xyz_corpus(args.xyz)
    if len(blocks) != len(graphs):
        raise ValueError(f"{len(blocks)} xyz blocks vs {len(graphs)} graphs")
    for g, block in zip(graphs, blocks):
        _, pos = read_xyz_block(block)
        n = int(g["atom_type"].shape[0])
        if pos.shape != (n, 3):
            raise ValueError(f"xyz block has {pos.shape}, graph has {n} atoms")
        g[args.key] = pos.astype(np.float32)

    save_dataset(args.out, graphs, feat_dict=feat_dict)
    print(f"Attached {args.key} to {len(graphs)} graphs -> {args.out}")


if __name__ == "__main__":
    main()
