"""The reference's side of a sampling cell's check: from the traffic's own
graphs and the members' weights (the checkpoint files, or the weights the
benchmark drew), the reference works out the batch, the edges, the start
and each checked step's update, in float32 with TF32 off.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench.reference import graphs as G
from portbench.reference.condensed import CondensedReference, load_params, to_device
from portbench.reference.dualenc import DualReference
from portbench.reference.walk import LangevinWalk


@contextlib.contextmanager
def exact_float32():
    """float32 products as float32, not TF32, inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class WalkReference:
    """``members``: the checkpoint paths of a condensed ensemble, or the
    dual encoder's drawn weights (a name -> tensor dict)."""

    def __init__(self, config: dict, traffic: dict, members, device):
        self.device = device
        self.traffic = traffic
        self.dual = config["network"] == "dualenc"
        if self.dual:
            self.net = DualReference(config)
            self.params = [{k: v.detach().float().to(device) for k, v in members.items()}]
            self.clip = None            # the dual walk clips the global branch only
        else:
            self.net = CondensedReference(config)
            self.params = [to_device(load_params(p)[0], device) for p in members]
            self.clip = traffic["clip"]
        self.walk = LangevinWalk(config, traffic["n_steps"], traffic["respacing"],
                                 traffic["step_lr"])

    def steps_to_check(self, seed: int, walk_index: int, count: int) -> list[int]:
        """Step 0 and ``count - 1`` steps drawn from the seed among those whose
        score part ``b`` is at least the traffic's ``check.min_b``: below it
        the update is a few float32 roundings of the positions."""
        eligible = [k for k in range(1, self.walk.n_walk)
                    if self.walk.b[k] >= self.traffic["check"]["min_b"]]
        rng = np.random.default_rng([seed, walk_index + 1000, 4])
        return [0] + sorted(int(k) for k in rng.choice(eligible, count - 1, replace=False))

    def score(self, batch: dict, st: dict, pos: torch.Tensor) -> torch.Tensor:
        if self.dual:
            return self.net.ensemble_score(self.params, batch, st, pos, gate=1.0,
                                           w_global=0.2, clip=self.traffic["clip"])
        return self.net.ensemble_score(self.params, batch, st, pos)

    @torch.no_grad()
    def step_gaps(self, rows: list, n_pad: int, pos_init, noise, traj, steps: list[int],
                  real: int) -> np.ndarray:
        """(steps, real graphs): ``|program's step k - reference's step k from
        the program's positions before it| / |the reference's score part|``,
        norms over each graph's atoms; step 0 starts from the reference's own
        start."""
        with exact_float32():
            batch = G.dense_batch(rows, n_pad, self.device)
            st = self.net.static(batch)
            mask = batch["node_mask"]
            out = np.zeros((len(steps), real))
            for i, k in enumerate(steps):
                pos = self.walk.start(pos_init, mask) if k == 0 else traj[k - 1]
                eps = self.score(batch, st, pos)
                nxt, part = self.walk.update(k, pos, eps, noise[k], mask, self.clip)
                gap = (traj[k] - nxt).flatten(1).norm(dim=1)
                den = part.flatten(1).norm(dim=1)
                out[i] = (gap / den)[:real].cpu().numpy()
            return out
