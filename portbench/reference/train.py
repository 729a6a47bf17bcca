"""TSDiff's training step in plain torch, float32 with TF32 off: the
denoising loss of the condensed encoder over every pair of atoms, its
gradient by autograd, and Adam.

* A graph at timestep t has its coordinates perturbed in the scaled frame,
  ``pos + noise * sqrt(1 - abar_t) / sqrt(abar_t)``; the target of each
  output edge is ``(d_true - d_perturbed) * sqrt(abar_t) / sqrt(1 - abar_t)``;
  both the network's distance scores and the targets are chain-ruled to the
  atoms over the output edges of the perturbed geometry; the loss is the
  squared error summed over xyz and atoms, over the batch's real atoms.
* The update (as the published optimizer chain): the gradient scaled to
  global norm ``max_grad_norm`` where it is at least that; Adam with
  ``b1, b2``, bias corrections ``1 - b^count`` and ``eps = 1e-8`` outside the
  root; ``p -= lr * update``.
"""

from __future__ import annotations

import torch

from portbench.reference import graphs as G
from portbench.reference.condensed import CondensedReference
from portbench.reference.walk import alpha_bars


class TrainReference:
    def __init__(self, config: dict, optimizer: dict, max_grad_norm: float, lr: float,
                 matmul=torch.matmul):
        self.net = CondensedReference(config, matmul)
        self.alphas = torch.from_numpy(alpha_bars(config).astype("float64"))
        self.opt, self.max_norm, self.lr = optimizer, max_grad_norm, lr

    def loss_sum(self, p: dict, batch: dict, t: torch.Tensor, noise: torch.Tensor):
        """``(sum of the per-atom squared errors, real atoms)`` of a batch."""
        a = self.alphas.to(batch["pos"].device)[t].float()[:, None, None]
        mask = batch["node_mask"]
        m = mask[..., None].float()
        pos = batch["pos"]
        pert = (pos + noise * torch.sqrt(1 - a) / torch.sqrt(a)) * m
        st = self.net.static(batch)
        s, mask_out = self.net.pair_scores(p, batch, st, pert)
        d_pert = G.distances(pert)
        d_true = G.distances(pos)
        target = (d_true - d_pert) * torch.sqrt(a) / torch.sqrt(1 - a)
        node_eq = G.scores_to_atoms(s, pert, mask_out)
        pos_target = G.scores_to_atoms(torch.where(mask_out, target, torch.zeros_like(target)),
                                       pert, mask_out)
        err = ((node_eq - pos_target) ** 2).sum(-1)
        return (err * mask.float()).sum(), mask.float().sum()

    def grads(self, p: dict, batch: dict, t, noise, rows: int = 50):
        """``(loss, gradients)``: the loss over the batch's real atoms and its
        gradient, summed over blocks of ``rows`` graphs."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        n_atoms = batch["node_mask"].float().sum()
        total = 0.0
        grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
        for lo in range(0, t.shape[0], rows):
            sl = slice(lo, lo + rows)
            ls, _ = self.loss_sum(leaves, {k: v[sl] for k, v in batch.items()}, t[sl], noise[sl])
            g = torch.autograd.grad(ls / n_atoms, list(leaves.values()), allow_unused=True)
            for (k, _), gk in zip(leaves.items(), g):
                if gk is not None:
                    grads[k] += gk
            total += float(ls.detach())
        return total / float(n_atoms), grads

    def init_state(self, p: dict) -> dict:
        return {"count": 0, "mu": {k: torch.zeros_like(v) for k, v in p.items()},
                "nu": {k: torch.zeros_like(v) for k, v in p.items()}}

    def update(self, p: dict, grads: dict, state: dict) -> dict:
        return adam_update(p, grads, state, self.opt, self.max_norm, self.lr)


@torch.no_grad()
def adam_update(p: dict, grads: dict, state: dict, opt: dict, max_norm: float, lr: float) -> dict:
    """One optimizer step: the clipped gradient goes into the moments
    (``state``, updated), and the new parameters are returned."""
    b1, b2 = opt["beta1"], opt["beta2"]
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    scale = 1.0 if norm < max_norm else float(max_norm / norm)
    state["count"] += 1
    c = state["count"]
    out = {}
    for k, g in grads.items():
        g = g * scale
        state["mu"][k] = (1 - b1) * g + b1 * state["mu"][k]
        state["nu"][k] = (1 - b2) * g * g + b2 * state["nu"][k]
        u = (state["mu"][k] / (1 - b1 ** c)) / (torch.sqrt(state["nu"][k] / (1 - b2 ** c)) + 1e-8)
        out[k] = p[k] - lr * u
    return out
