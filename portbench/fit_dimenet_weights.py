"""Make the committed stand-in weights of the condensed network with
DimeNet++ (its configuration's ``weights``, ``weights_seed`` and ``fit``):

    python3 portbench/fit_dimenet_weights.py --config tsdiff-condensed-dimenetpp-h128 \
        [--device cuda] [--out PATH]

The model's weights drawn by the program's own initialisers from
``weights_seed`` (DimeNet++'s ``glorot_orthogonal``, the condensed wrapper's
uniform), then ``fit.iterations`` Adam steps of TSDiff's loss and optimizer
(``reference/train.py``'s loss and update) taken by the plain reference
(``reference/dimenetpp.py``) in float32 with TF32 off, on a pool of
``fit.pool`` reactions of the traffic ``fit.traffic`` drawn from the same
seed, in batches of ``fit.batch`` taken in turn.  The result is written
rounded to bfloat16 under the program's ``state_dict`` names, so that the
program and the reference read the same numbers; the benchmark's runs only
load the file.  Prints the loss every 25 steps.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE)]

from portbench import common, corpus  # noqa: E402
from portbench.walk import _seed_int  # noqa: E402


def fitted(cfg: dict, device: str) -> dict:
    import torch

    from portbench.reference.check import exact_float32
    from portbench.reference.dimenetpp import DimeNetReference
    from portbench.reference.graphs import dense_batch
    from portbench.reference.train import TrainReference
    from tsdiff_tpu_torch.config import Config
    from tsdiff_tpu_torch.models import get_model

    f, seed, T = cfg["fit"], cfg["weights_seed"], cfg["num_diffusion_timesteps"]
    model = get_model(Config(cfg["model"]), dtype=torch.float32,
                      generator=torch.Generator().manual_seed(seed))
    p = {k: v.detach().float().to(device) for k, v in model.state_dict().items()}
    traffic = dict(common.load_json("traffic", f"{f['traffic']}.json"), shard=f["pool"],
                   sort_by_size=False)
    pool = corpus.make_shard(traffic, seed, 10 ** 7)
    chunks = [pool[lo: lo + f["batch"]] for lo in range(0, len(pool), f["batch"])]
    dense = [dense_batch(g, max(len(x["atom_type"]) for x in g), device) for g in chunks]
    opt = cfg["optimizer"]
    ref = TrainReference(cfg, opt, cfg["max_grad_norm"], opt["lr"])
    ref.net = DimeNetReference(cfg)
    state = ref.init_state(p)
    with exact_float32():
        for i in range(f["iterations"]):
            batch = dense[i % len(dense)]
            gen = torch.Generator().manual_seed(_seed_int(seed, 7, i))
            B = batch["pos"].shape[0]
            half = torch.randint(0, T, (B // 2 + 1,), generator=gen)
            t = torch.cat([half, T - 1 - half])[:B].to(device)
            noise = torch.randn(batch["pos"].shape, generator=gen).to(device)
            loss, grads = ref.grads(p, batch, t, noise)
            p = ref.update(p, grads, state)
            if i % 25 == 0 or i == f["iterations"] - 1:
                print(f"step {i} loss {loss:.6g}", flush=True)
    return {k: v.detach().to("cpu", torch.bfloat16).contiguous() for k, v in p.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--device", default="cpu")
    p.add_argument("--out", default=None, help="default: the configuration's 'weights'")
    args = p.parse_args(argv)
    import torch

    cfg = common.load_json("configs", f"{args.config}.json")
    path = args.out or os.path.join(common.ROOT, cfg["weights"])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(fitted(cfg, args.device), path)
    print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
