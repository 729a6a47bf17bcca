"""The condensed encoder of TSDiff (arXiv:2304.12233) in plain torch, float32
with TF32 off, over every pair of atoms: no packing, no kernel, no cache.

Per member, on a batch padded to N atoms (B, N):

* node states ``z = [emb(Z) + W r_feat, W p_feat - W r_feat]`` (H/2 each);
* the encoder's edges: the reactant's and the product's bond graphs
  extended to ``edge_order`` hops, united with every pair within
  ``edge_cutoff``; the output head's edges likewise at ``pred_edge_order``;
* edge features ``edge_cat([mlp(d) * emb(type_r), mlp(d) * emb(type_p)])``
  (``edge_cat``: Linear(2H, H), swish, Linear(H, H));
* ``num_convs`` SchNet interactions over the encoder's edges within
  ``cutoff``: filter ``ssp(e W1 + b1) W2 + b2``, message ``filter * (h Wl1)``
  summed at the target, ``h += ssp(agg Wl2 + bl2) Wo + bo``;
* the distance score ``mlp([h_i * h_j, edge features at the output
  order])`` (Linear(2H, H), swish, Linear(H, H/2), swish, Linear(H/2, 1)),
  chain-ruled to atoms over the output head's edges.

Weights are read from the checkpoint file's own arrays (flax layout, kernels
(in, out)); the reference keeps them in float32 whatever the program serves.
"""

from __future__ import annotations

import pickle

import numpy as np

import torch
import torch.nn.functional as F

from portbench.reference import graphs as G


def load_params(path: str) -> tuple[dict, dict]:
    """``(params, model config)`` of a ``.ckpt`` file: the nested flax
    parameter tree flattened to ``a/b/c`` names, float32 numpy arrays."""
    with open(path, "rb") as f:
        ck = pickle.load(f)
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = v
    tree = ck["params"]
    walk(tree.get("params", tree), "")
    return flat, ck["config"]["model"]


#: the program's embedding tables, by their torch names
_EMBEDDINGS = {"atom_embedding.weight": "atom_embedding/embedding",
               "edge_enc.bond_emb.weight": "edge_enc/bond_emb/embedding"}


def reference_name(torch_name: str) -> tuple[str, bool]:
    """``(the reference's name, whether the tensor is transposed)`` of a
    parameter named as the program's ``state_dict`` names it: torch
    ``Linear`` weights (out, in) are the reference's kernels (in, out)."""
    if torch_name in _EMBEDDINGS:
        return _EMBEDDINGS[torch_name], False
    parts = torch_name.split(".")
    if parts[:2] == ["encoder", "stack"]:
        return "/".join(parts), False
    *module, leaf = parts
    path = []
    for i, part in enumerate(module):
        if part == "layers":
            continue
        path.append(f"layers_{part}" if i and module[i - 1] == "layers" else part)
    return "/".join(path + ["Dense_0", "kernel" if leaf == "weight" else "bias"]), leaf == "weight"


def from_torch_names(state: dict) -> dict:
    """The reference's parameters from tensors under the program's names."""
    out = {}
    for name, t in state.items():
        ref, transposed = reference_name(name)
        t = t.detach().float()
        out[ref] = t.t().contiguous() if transposed else t.clone()
    return out


def to_device(params: dict, device) -> dict:
    return {k: torch.tensor(np.asarray(v), dtype=torch.float32, device=device)
            for k, v in params.items()}


def fp8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with both operands rounded to float8 (e4m3), each scaled by
    its largest magnitude over 448: the precision below bfloat16, for the
    check's control."""
    def q(t):
        s = t.detach().abs().amax().clamp(min=1e-30) / 448.0
        return (t / s).to(torch.float8_e4m3fn).float() * s
    return q(x) @ q(w)


def _ssp(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x) - torch.log(torch.tensor(2.0, dtype=x.dtype, device=x.device))


class CondensedReference:
    """One configuration's plain condensed encoder; ``score`` gives one
    member's per-atom score, ``ensemble_score`` the members' mean."""

    def __init__(self, config: dict, matmul=torch.matmul):
        self.mm = matmul
        self.H = config["hidden_dim"]
        self.L = config["num_convs"]
        self.order_in = config["edge_order"]
        self.order_out = config["pred_edge_order"]
        self.edge_cutoff = config["edge_cutoff"]
        self.cutoff = config["cutoff"]

    def static(self, batch: dict) -> dict:
        """What depends on the batch's graphs alone."""
        mask_in, tr_in, tp_in = G.typed_edges(batch["bond_mat"], batch["node_mask"], self.order_in)
        mask_out, tr_out, tp_out = G.typed_edges(batch["bond_mat"], batch["node_mask"],
                                                 self.order_out)
        return dict(mask_in=mask_in, tr_in=tr_in, tp_in=tp_in, mask_out=mask_out,
                    tr_out=tr_out, tp_out=tp_out, pm=G.pair_mask(batch["node_mask"]))

    def _dense(self, p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.mm(x, p[f"{name}/Dense_0/kernel"]) + p[f"{name}/Dense_0/bias"]

    def node_states(self, p: dict, batch: dict) -> torch.Tensor:
        w = p["atom_feat_embedding/Dense_0/kernel"]
        af_r, af_p = self.mm(batch["r_feat"], w), self.mm(batch["p_feat"], w)
        a = p["atom_embedding/embedding"][batch["atom_type"]]
        z = torch.cat([a + af_r, af_p - af_r], dim=-1)
        return z * batch["node_mask"][..., None].float()

    def pair_scores(self, p: dict, batch: dict, st: dict, pos: torch.Tensor):
        """``(s (B, N, N), output edge mask)``: one member's distance scores."""
        d = G.distances(pos)
        radius = st["pm"] & (d <= self.edge_cutoff)
        mask_in = st["mask_in"] | radius
        mask_out = st["mask_out"] | radius
        d_in = torch.where(mask_in, d, torch.ones_like(d))[..., None]
        mm, dense = self.mm, self._dense
        d_emb = dense(p, "edge_enc/mlp/layers_1", F.silu(dense(p, "edge_enc/mlp/layers_0", d_in)))
        table = p["edge_enc/bond_emb/embedding"]

        def edge_features(tr, tp):
            x = torch.cat([d_emb * table[tr], d_emb * table[tp]], dim=-1)
            return dense(p, "edge_cat/lin1", F.silu(dense(p, "edge_cat/lin0", x)))

        e = edge_features(st["tr_in"], st["tp_in"])
        c = ((d_in[..., 0] <= self.cutoff) & mask_in).float()[..., None]
        h = self.node_states(p, batch)
        s = "encoder/stack/"
        for l in range(self.L):
            filt = mm(_ssp(mm(e, p[s + "f1w"][l]) + p[s + "f1b"][l]), p[s + "f2w"][l]) \
                + p[s + "f2b"][l]
            msg = filt * c * mm(h, p[s + "l1w"][l])[:, :, None, :]     # source i -> target j
            agg = msg.sum(1)
            h = h + mm(_ssp(mm(agg, p[s + "l2w"][l]) + p[s + "l2b"][l]), p[s + "ow"][l]) \
                + p[s + "ob"][l]
        e_out = edge_features(st["tr_out"], st["tp_out"])
        x = torch.cat([h[:, :, None, :] * h[:, None, :, :], e_out], dim=-1)
        x = F.silu(dense(p, "grad_dist_mlp/layers_0", x))
        x = F.silu(dense(p, "grad_dist_mlp/layers_1", x))
        return dense(p, "grad_dist_mlp/layers_2", x)[..., 0], mask_out

    def score(self, p: dict, batch: dict, st: dict, pos: torch.Tensor) -> torch.Tensor:
        s, mask_out = self.pair_scores(p, batch, st, pos)
        return G.scores_to_atoms(s, pos, mask_out)

    @torch.no_grad()
    def ensemble_score(self, members: list[dict], batch: dict, st: dict,
                       pos: torch.Tensor, rows: int = 25) -> torch.Tensor:
        """The mean of the members' per-atom scores, in blocks of ``rows``
        graphs so that the pair grids fit."""
        out = []
        for lo in range(0, pos.shape[0], rows):
            sl = slice(lo, lo + rows)
            sub = {k: v[sl] for k, v in batch.items()}
            sst = {k: v[sl] for k, v in st.items()}
            out.append(torch.stack([self.score(p, sub, sst, pos[sl]) for p in members]).mean(0))
        return torch.cat(out)
