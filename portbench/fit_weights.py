"""Make the committed stand-in weights of a configuration that has no
checkpoint (its ``weights``, ``weights_seed`` and ``fit``):

    python3 portbench/fit_weights.py --config geodiff-qm9-dualenc

On the CPU, in float32: the model's weights drawn from ``weights_seed``
(``walk.draw_weights``), then ``fit.iterations`` Adam steps of the published
loss and optimizer taken by the plain reference (``reference/dualenc.py``)
on a pool of ``fit.pool`` molecules of the traffic ``fit.traffic``, drawn
from the same seed, in batches of ``fit.batch`` taken in turn.  The result
depends on the seed alone; the benchmark's runs only load the file.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE)]

from portbench import common, corpus  # noqa: E402
from portbench.walk import _seed_int, draw_weights  # noqa: E402


def fitted(cfg: dict) -> dict:
    import torch

    from portbench.reference.check import exact_float32
    from portbench.reference.dualenc import DualReference, fit
    from portbench.reference.graphs import dense_batch
    from portbench.reference.walk import alpha_bars
    from tsdiff_tpu_torch.config import Config
    from tsdiff_tpu_torch.models import get_model

    f, seed, T = cfg["fit"], cfg["weights_seed"], cfg["num_diffusion_timesteps"]
    model = get_model(Config(cfg["model"]), dtype=torch.float32)
    weights = draw_weights(model, seed, "cpu")
    traffic = dict(common.load_json("traffic", f"{f['traffic']}.json"), shard=f["pool"],
                   sort_by_size=False)
    pool = corpus.make_shard(traffic, seed, 10 ** 7)
    chunks = [pool[lo: lo + f["batch"]] for lo in range(0, len(pool), f["batch"])]
    dense = [dense_batch(g, max(len(x["atom_type"]) for x in g), "cpu") for g in chunks]
    batches = (dense[i % len(dense)] for i in range(f["iterations"]))
    alphas = torch.from_numpy(alpha_bars(cfg))

    def draws(i, batch):
        gen = torch.Generator().manual_seed(_seed_int(seed, 7, i))
        B = batch["pos"].shape[0]
        half = torch.randint(0, T, (B // 2 + 1,), generator=gen)
        return torch.cat([half, T - 1 - half])[:B], torch.randn(batch["pos"].shape, generator=gen)
    with exact_float32():
        p = fit(DualReference(cfg), weights, batches, alphas, draws, cfg["optimizer"],
                cfg["max_grad_norm"])
    return {k: v.detach().contiguous() for k, v in p.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    args = p.parse_args(argv)
    import torch

    cfg = common.load_json("configs", f"{args.config}.json")
    path = os.path.join(common.ROOT, cfg["weights"])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(fitted(cfg), path)
    print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
