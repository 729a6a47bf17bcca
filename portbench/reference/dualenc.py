"""GeoDiff's dual encoder (arXiv:2203.02923) in plain torch, float32 with
TF32 off, over every pair of atoms.

On a molecule padded to N atoms:

* edges: the bond graph extended to ``edge_order`` hops (k >= 2 hops typed
  ``22 ** 2 + k - 1``, bonds keep their code), united with every pair within
  ``cutoff`` (radius-only pairs typed 0); the local edges are the typed ones;
* each branch's edge features ``mlp(d) * emb(type')``, ``type'`` the code
  with a k-hop code mapped to ``22 + k - 1`` and a bond code to ``code % 22``;
* global branch: SchNet (atom embedding rows clipped to norm 10, then
  ``num_convs`` interactions over the edges within ``cutoff``); local
  branch: GIN (``num_convs_local`` layers, ``mlp(sum_i relu(x_i + e_ij) + x_j)``,
  relu between layers, residual);
* each branch's distance score ``mlp([h_i * h_j, e_ij])`` (relu), chain-ruled
  to atoms: the local one over the local edges, the global one over the
  other edges and clipped to ``clip``; the score is ``local + gate *
  w_global * global``.

Weights come by their names in the program's ``state_dict`` layout (torch
``Linear`` weights (out, in); the SchNet stack (L, in, out)), as the
benchmark draws them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.corpus import NUM_BOND_TYPES
from portbench.reference import graphs as G

EMBEDDING_MAX_NORM = 10.0


def _lin(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ p[f"{name}.weight"].t() + p[f"{name}.bias"]


def _mlp(p: dict, name: str, x: torch.Tensor, layers: int) -> torch.Tensor:
    for i in range(layers):
        x = _lin(p, f"{name}.layers.{i}", x)
        if i < layers - 1:
            x = F.relu(x)
    return x


def _ssp(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x) - torch.log(torch.tensor(2.0, dtype=x.dtype, device=x.device))


class DualReference:
    def __init__(self, config: dict):
        self.L = config["num_convs"]
        self.L_local = config["num_convs_local"]
        self.order = config["edge_order"]
        self.cutoff = config["cutoff"]

    def static(self, batch: dict) -> dict:
        mask, types = G.legacy_edges(batch["bond_mat"], batch["node_mask"], self.order)
        return dict(mask_typed=mask, types=types, pm=G.pair_mask(batch["node_mask"]))

    def _embed_types(self, types: torch.Tensor) -> torch.Tensor:
        nb = NUM_BOND_TYPES
        hop = types // nb ** 2 != 0
        return torch.where(hop, types % nb ** 2 + nb, types % nb)

    def branches(self, p: dict, batch: dict, st: dict, pos: torch.Tensor):
        """``(s_global, s_local, edges, local edges)``: both branches'
        distance scores (B, N, N) on ``pos``."""
        d = G.distances(pos)
        mask = st["mask_typed"] | (st["pm"] & (d <= self.cutoff))
        types = torch.where(mask, st["types"], torch.zeros_like(st["types"]))
        local = types > 0
        d_m = torch.where(mask, d, torch.ones_like(d))
        t = self._embed_types(types)

        def features(name):
            d_emb = _mlp(p, f"{name}.mlp", d_m[..., None], 2)
            return d_emb * p[f"{name}.bond_emb.weight"][t]

        node_mask = batch["node_mask"][..., None].float()
        # global branch: SchNet
        e_g = features("edge_encoder_global")
        h = p["encoder_global.node_emb.weight"][batch["atom_type"]]
        h = h * torch.clamp(EMBEDDING_MAX_NORM / h.norm(dim=-1, keepdim=True).clamp(min=1e-12),
                            max=1.0)
        h = h * node_mask
        c = ((d_m <= self.cutoff) & mask).float()[..., None]
        s = "encoder_global.stack."
        for l in range(self.L):
            filt = _ssp(e_g @ p[s + "f1w"][l] + p[s + "f1b"][l]) @ p[s + "f2w"][l] + p[s + "f2b"][l]
            agg = (filt * c * (h @ p[s + "l1w"][l])[:, :, None, :]).sum(1)
            h = h + _ssp(agg @ p[s + "l2w"][l] + p[s + "l2b"][l]) @ p[s + "ow"][l] + p[s + "ob"][l]
        s_g = _mlp(p, "grad_global_dist_mlp",
                   torch.cat([h[:, :, None, :] * h[:, None, :, :], e_g], dim=-1), 3)[..., 0]
        # local branch: GIN
        e_l = features("edge_encoder_local")
        x = p["encoder_local.node_emb.weight"][batch["atom_type"]] * node_mask
        lm = local[..., None].float()
        for i in range(self.L_local):
            agg = (F.relu(x[:, :, None, :] + e_l) * lm).sum(1)
            out = _mlp(p, f"encoder_local.convs.{i}.nn", agg + x, 2)
            if i < self.L_local - 1:
                out = F.relu(out)
            x = out + x
        s_l = _mlp(p, "grad_local_dist_mlp",
                   torch.cat([x[:, :, None, :] * x[:, None, :, :], e_l], dim=-1), 3)[..., 0]
        return s_g, s_l, mask, local

    def score(self, p: dict, batch: dict, st: dict, pos: torch.Tensor, gate: float,
              w_global: float, clip: float) -> torch.Tensor:
        s_g, s_l, mask, local = self.branches(p, batch, st, pos)
        eps_local = G.scores_to_atoms(s_l, pos, local)
        eps_global = G.scores_to_atoms(torch.where(local, torch.zeros_like(s_g), s_g), pos, mask)
        return eps_local + gate * w_global * G.clip_norm(eps_global, clip)

    def loss_sum(self, p: dict, batch: dict, alphas: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor):
        """GeoDiff's denoising loss (``type: diffusion``): ``(sum over real
        atoms of (2 global + 5 local) / 7, real atoms)``.  The coordinates are
        perturbed in the scaled frame, the target of an edge is ``(d_true -
        d_perturbed) sqrt(abar) / sqrt(1 - abar)``; the local branch is
        scored on the local edges, the global one on the other edges within
        the cutoff, each chain-ruled over its edges."""
        a = alphas[t][:, None, None]
        m = batch["node_mask"][..., None].float()
        pos = batch["pos"]
        pert = (pos + noise * torch.sqrt(1 - a) / torch.sqrt(a)) * m
        st = self.static(batch)
        s_g, s_l, mask, local = self.branches(p, batch, st, pert)
        d_pert = G.distances(pert)
        target = (G.distances(pos) - d_pert) * torch.sqrt(a) / torch.sqrt(1 - a)
        zero = torch.zeros_like(target)
        glob = ((d_pert <= self.cutoff) | local) & ~local & mask
        err_g = (G.scores_to_atoms(torch.where(glob, s_g, zero), pert, mask)
                 - G.scores_to_atoms(torch.where(glob, target, zero), pert, mask))
        err_l = (G.scores_to_atoms(torch.where(local, s_l, zero), pert, local)
                 - G.scores_to_atoms(torch.where(local, target, zero), pert, local))
        node = (2.0 * (err_g ** 2).sum(-1) + 5.0 * (err_l ** 2).sum(-1)) / 7.0
        mask = batch["node_mask"].float()
        return (node * mask).sum(), mask.sum()

    @torch.no_grad()
    def ensemble_score(self, members: list[dict], batch: dict, st: dict, pos: torch.Tensor,
                       gate: float, w_global: float, clip: float, rows: int = 50) -> torch.Tensor:
        out = []
        for lo in range(0, pos.shape[0], rows):
            sl = slice(lo, lo + rows)
            sub = {k: v[sl] for k, v in batch.items()}
            sst = {k: v[sl] for k, v in st.items()}
            out.append(torch.stack([self.score(p, sub, sst, pos[sl], gate, w_global, clip)
                                    for p in members]).mean(0))
        return torch.cat(out)


def fit(net: DualReference, p: dict, batches, alphas: torch.Tensor, draws, opt: dict,
        max_norm: float) -> dict:
    """``p`` after one Adam step of the denoising loss per batch of
    ``batches`` (dense batches), ``draws(i, batch) -> (t, noise)``."""
    from portbench.reference.train import adam_update

    state = {"count": 0, "mu": {k: torch.zeros_like(v) for k, v in p.items()},
             "nu": {k: torch.zeros_like(v) for k, v in p.items()}}
    for i, batch in enumerate(batches):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        t, noise = draws(i, batch)
        ls, n = net.loss_sum(leaves, batch, alphas, t, noise)
        grads = torch.autograd.grad(ls / n, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)}
        p = adam_update(p, grads, state, opt, max_norm, opt["lr"])
    return p
