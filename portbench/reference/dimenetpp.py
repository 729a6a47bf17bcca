"""TSDiff's condensed network with the DimeNet++ encoder in plain torch,
float32 with TF32 off, graph by graph over explicit index lists: no dense
grid of triplets, no packing, no kernel.

DimeNet++ as published (Gasteiger et al., arXiv:2011.14115; the
implementations it names, PyG's ``DimeNetPlusPlus`` and DIG's ``dimenetpp``),
on a batch taken as the disjoint union of its graphs:

* the encoder's directed edges j -> i are the pairs of the condensed encoder
  graph (both sides' bonds extended to ``edge_order`` hops, united with the
  pairs within ``edge_cutoff``); the triplets k -> j -> i are every pair of
  edges (k -> j, j -> i) with k != i, listed explicitly;
* radial basis ``u(d/c) sin(f_n d/c)``, ``f_n`` learned from ``n pi``, ``u``
  the envelope polynomial of exponent p (``1/x + a x^(p-1) + b x^p + c
  x^(p+1)``, zero from x = 1); spherical basis ``norm_ln j_l(z_ln d_kj/c)
  u(d_kj/c) Y_l^0(angle_kji)``, the ``z_ln`` the first zeros of the
  spherical Bessel functions, found here by bisection in float64 from the
  interlacing of the orders, ``Y_l^0`` by Bonnet's recurrence;
* an embedding block, then per interaction block: ``x_ji``, ``x_kj`` by
  their own layers, ``x_kj`` times the block's radial projection, down to
  ``int_emb``, times the block's own two-layer projection of the spherical
  basis (``lin_sbf1`` to ``basis_emb``, ``lin_sbf2`` to ``int_emb``) per
  triplet, summed over k into the edge j -> i, up, added to ``x_ji``; the
  residual layers before the skip, the skip, the layers after it; an output
  block per block (radial projection, sum over the edges into their target,
  up to ``out_emb``, the output layers, down to the node width).

Where this departs from the paper, as TSDiff's condensed network does
(seonghann/tsdiff ``models/encoder/dimenetpp.py``) and the program follows:

* the node states are given (the condensed wrapper's), not embedded from
  the atom types, and the node output is the node width H;
* the edge features ``edge_attr`` (the wrapper's ``edge_cat`` at the
  encoder order) modulate the embedding block's radial part,
  ``rbf0 = edge_attr * act(W rbf) + edge_attr``, and each block's radial
  projection, ``x_kj * (edge_attr * W2 W1 rbf)``;
* the nodes' features are the last output block's, not the sum over the
  output blocks (TSDiff needs node features, not a molecule's energy);
* the cutoff is the encoder graph's, 10 A, and an edge of the graph beyond
  it keeps its state: its radial basis is zero.

Around it the condensed wrapper as ``condensed.py`` documents it (node
states, edge features, the distance head and its chain rule to atoms).
Parameters are read under the program's ``state_dict`` names, torch layout
(``Linear`` weights (out, in)).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import graphs as G
from portbench.reference.check import WalkReference
from portbench.reference.walk import LangevinWalk


# -- the bases ----------------------------------------------------------------------


def spherical_jn(l: int, x: np.ndarray | torch.Tensor):
    """``j_l(x)`` in float64: the power series for x < 1 (the upward
    recurrence cancels there), the upward recurrence from ``j_0``, ``j_1``
    above."""
    lib = torch if isinstance(x, torch.Tensor) else np
    x = x.double() if lib is torch else np.asarray(x, np.float64)
    small = x < 1.0
    xs = lib.where(small, x, lib.ones_like(x))
    xl = lib.where(small, lib.ones_like(x), x)
    # series: x^l / (2l+1)!! * sum_m (-x^2/2)^m / (m! (2l+3)(2l+5)...(2l+2m+1))
    term = xs ** l / float(np.prod(np.arange(1, 2 * l + 2, 2)))
    series = term
    for m in range(1, 12):
        term = term * (-xs * xs / 2.0) / (m * (2 * l + 2 * m + 1))
        series = series + term
    j0 = lib.sin(xl) / xl
    j1 = lib.sin(xl) / xl ** 2 - lib.cos(xl) / xl
    prev, cur = j0, j1
    if l == 0:
        cur = j0
    for k in range(1, l):
        prev, cur = cur, (2 * k + 1) / xl * cur - prev
    return lib.where(small, series, cur)


def bessel_zeros(num_spherical: int, num_radial: int) -> np.ndarray:
    """(ns, nr) float64: the first ``num_radial`` positive zeros of
    ``j_0 .. j_{ns-1}``, each by bisection between two consecutive zeros of
    the order below (``j_0``'s are ``n pi``)."""
    need = num_radial + num_spherical
    prev = np.arange(1, need + 1) * np.pi
    out = np.zeros((num_spherical, num_radial))
    out[0] = prev[:num_radial]
    for l in range(1, num_spherical):
        roots = []
        for a, b in zip(prev[:-1], prev[1:]):
            fa = spherical_jn(l, np.float64(a))
            for _ in range(200):
                mid = 0.5 * (a + b)
                fm = spherical_jn(l, np.float64(mid))
                if np.sign(fm) == np.sign(fa):
                    a, fa = mid, fm
                else:
                    b = mid
            roots.append(0.5 * (a + b))
        prev = np.asarray(roots)
        out[l] = prev[:num_radial]
    return out


def bessel_norms(zeros: np.ndarray) -> np.ndarray:
    """``1 / sqrt(j_{l+1}(z_ln)^2 / 2)``: unit norm on [0, 1] under x^2 dx."""
    return np.stack([1.0 / np.sqrt(0.5 * spherical_jn(l + 1, zeros[l]) ** 2)
                     for l in range(zeros.shape[0])])


def zonal_harmonics(num_spherical: int, cos_angle: torch.Tensor) -> torch.Tensor:
    """(T, ns) float64: ``Y_l^0 = sqrt((2l + 1) / 4 pi) P_l(cos)``, ``P_l``
    by Bonnet's recurrence."""
    z = cos_angle.double()
    P = [torch.ones_like(z), z]
    for l in range(2, num_spherical):
        P.append(((2 * l - 1) * z * P[l - 1] - (l - 1) * P[l - 2]) / l)
    return torch.stack([math.sqrt((2 * l + 1) / (4 * math.pi)) * P[l]
                        for l in range(num_spherical)], dim=-1)


def envelope(x: torch.Tensor, exponent: int) -> torch.Tensor:
    p = exponent + 1
    a, b, c = -(p + 1) * (p + 2) / 2.0, p * (p + 2), -p * (p + 1) / 2.0
    out = 1.0 / x + a * x ** (p - 1) + b * x ** p + c * x ** (p + 1)
    return torch.where(x < 1.0, out, torch.zeros_like(out))


# -- the network -----------------------------------------------------------------------


class DimeNetReference:
    """The condensed network with DimeNet++ of a configuration (the
    benchmark's configuration file; widths from its ``model``): ``score``
    one member's per-atom score, ``ensemble_score`` the members' mean, as
    ``condensed.CondensedReference``; ``matmul`` takes every product of a
    layer (the check's control: ``condensed.fp8_matmul``)."""

    def __init__(self, config: dict, matmul=torch.matmul):
        self.mm = matmul
        m, enc = config["model"], config["model"]["encoder"]
        self.H = m["hidden_dim"]
        self.order_in, self.order_out = m["edge_order"], m["pred_edge_order"]
        self.edge_cutoff = m["edge_cutoff"]
        self.cutoff = enc["cutoff"]
        self.L = enc["num_convs"]
        self.ns, self.nr = enc["num_spherical"], enc["num_radial"]
        self.p = enc.get("envelope_exponent", 5)
        self.before, self.after = enc["num_before_skip"], enc["num_after_skip"]
        self.out_layers = enc.get("num_output_layers", 3)
        zeros = bessel_zeros(self.ns, self.nr)
        self.zeros, self.norms = zeros, bessel_norms(zeros)

    # the wrapper's pieces, on lists of pairs
    def lin(self, p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
        y = self.mm(x, p[f"{name}.weight"].t())
        return y + p[f"{name}.bias"] if f"{name}.bias" in p else y

    def static(self, batch: dict) -> dict:
        mask_in, tr_in, tp_in = G.typed_edges(batch["bond_mat"], batch["node_mask"], self.order_in)
        mask_out, tr_out, tp_out = G.typed_edges(batch["bond_mat"], batch["node_mask"],
                                                 self.order_out)
        return dict(mask_in=mask_in, tr_in=tr_in, tp_in=tp_in, mask_out=mask_out,
                    tr_out=tr_out, tp_out=tp_out, pm=G.pair_mask(batch["node_mask"]))

    def node_states(self, p: dict, batch: dict) -> torch.Tensor:
        w = p["atom_feat_embedding.weight"].t()
        af_r, af_p = batch["r_feat"] @ w, batch["p_feat"] @ w
        a = p["atom_embedding.weight"][batch["atom_type"]]
        return torch.cat([a + af_r, af_p - af_r], dim=-1)

    def edge_features(self, p: dict, d: torch.Tensor, tr: torch.Tensor, tp: torch.Tensor):
        """``edge_cat([mlp(d) * emb(type_r), mlp(d) * emb(type_p)])`` of a list
        of pairs."""
        d_emb = self.lin(p, "edge_enc.mlp.layers.1",
                         F.silu(self.lin(p, "edge_enc.mlp.layers.0", d[:, None])))
        table = p["edge_enc.bond_emb.weight"]
        x = torch.cat([d_emb * table[tr], d_emb * table[tp]], dim=-1)
        return self.lin(p, "edge_cat.lin1", F.silu(self.lin(p, "edge_cat.lin0", x)))

    def residual(self, p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
        return x + F.silu(self.lin(p, f"{name}.lin2", F.silu(self.lin(p, f"{name}.lin1", x))))

    def output_block(self, p: dict, tag: str, e2: torch.Tensor, tgt: torch.Tensor,
                     n_nodes: int) -> torch.Tensor:
        v = torch.zeros(n_nodes, e2.shape[1], dtype=e2.dtype, device=e2.device)
        v.index_add_(0, tgt, e2)
        v = self.lin(p, f"encoder.{tag}_lin_up", v)
        for li in range(self.out_layers):
            v = F.silu(self.lin(p, f"encoder.{tag}_lins_{li}", v))
        return self.lin(p, f"encoder.{tag}_lin", v)

    def encoder(self, p: dict, z, pos, tgt, src, ea) -> torch.Tensor:
        """DimeNet++ over the directed edges ``src -> tgt`` (indices into the
        nodes of the union): per-node features (nodes, H)."""
        n_nodes, E = z.shape[0], tgt.shape[0]
        lin = lambda name, x: self.lin(p, f"encoder.{name}", x)  # noqa: E731
        d = (pos[tgt] - pos[src]).norm(dim=-1)
        x = d / self.cutoff
        u = envelope(x, self.p)
        rbf = u[:, None] * torch.sin(p["encoder.dist_emb.freq"] * x[:, None])
        # triplets k -> j -> i: edge kj ends where edge ji starts, k != i
        deg = torch.bincount(tgt, minlength=n_nodes)
        first = torch.cumsum(deg, 0) - deg
        by_tgt = torch.argsort(tgt, stable=True)
        rep = deg[src]
        idx_ji = torch.repeat_interleave(torch.arange(E, device=z.device), rep)
        offset = torch.arange(idx_ji.shape[0], device=z.device) \
            - torch.repeat_interleave(torch.cumsum(rep, 0) - rep, rep)
        idx_kj = by_tgt[torch.repeat_interleave(first[src], rep) + offset]
        keep = src[idx_kj] != tgt[idx_ji]
        idx_ji, idx_kj = idx_ji[keep], idx_kj[keep]
        i, j, k = tgt[idx_ji], src[idx_ji], src[idx_kj]
        v_ji, v_jk = pos[i] - pos[j], pos[k] - pos[j]
        angle = torch.atan2(torch.linalg.cross(v_ji, v_jk).norm(dim=-1), (v_ji * v_jk).sum(-1))
        # the spherical basis (T, ns * nr), l-major
        zeros = torch.from_numpy(self.zeros).to(z.device)
        norms = torch.from_numpy(self.norms).to(z.device)
        arg = x.double()[idx_kj, None, None] * zeros
        jl = torch.stack([spherical_jn(l, arg[:, l]) for l in range(self.ns)], dim=1)
        radial = norms * jl * u.double()[idx_kj, None, None]
        sbf = (radial * zonal_harmonics(self.ns, torch.cos(angle))[:, :, None]).float()
        sbf = sbf.reshape(-1, self.ns * self.nr)

        rbf0 = F.silu(lin("init_lin_rbf_0", rbf))
        rbf0 = ea * rbf0 + ea
        e1 = F.silu(lin("init_lin", torch.cat([z[tgt], z[src], rbf0], dim=-1)))
        e2 = lin("init_lin_rbf_1", rbf) * e1
        v = self.output_block(p, "v_init", e2, tgt, n_nodes)
        for l in range(self.L):
            b = f"e{l}"
            x_ji = F.silu(lin(f"{b}_lin_ji", e1))
            x_kj = F.silu(lin(f"{b}_lin_kj", e1))
            x_kj = x_kj * (ea * lin(f"{b}_lin_rbf2", lin(f"{b}_lin_rbf1", rbf)))
            x_kj = F.silu(lin(f"{b}_lin_down", x_kj))
            s = lin(f"{b}_lin_sbf2", self.mm(sbf, p[f"encoder.{b}_lin_sbf1"]))
            agg = torch.zeros(E, s.shape[1], dtype=s.dtype, device=s.device)
            agg.index_add_(0, idx_ji, x_kj[idx_kj] * s)
            h = x_ji + F.silu(lin(f"{b}_lin_up", agg))
            for r in range(self.before):
                h = self.residual(p, f"encoder.{b}_res_before_{r}", h)
            h = F.silu(lin(f"{b}_lin", h)) + e1
            for r in range(self.after):
                h = self.residual(p, f"encoder.{b}_res_after_{r}", h)
            e1 = h
            e2 = lin(f"{b}_lin_rbf", rbf) * e1
            v = self.output_block(p, f"v{l}", e2, tgt, n_nodes)
        return v

    def pair_scores(self, p: dict, batch: dict, st: dict, pos: torch.Tensor):
        """``(s (B, N, N), output edge mask)``: one member's distance scores,
        zero off the output edges."""
        B, N = batch["node_mask"].shape
        d = G.distances(pos)
        radius = st["pm"] & (d <= self.edge_cutoff)
        mask_in = st["mask_in"] | radius
        mask_out = st["mask_out"] | radius
        b_in, tgt, src = torch.nonzero(mask_in, as_tuple=True)
        ea = self.edge_features(p, d[b_in, tgt, src], st["tr_in"][b_in, tgt, src],
                                st["tp_in"][b_in, tgt, src])
        real = batch["node_mask"].reshape(-1)
        node = torch.cumsum(real.long(), 0) - 1      # index of each real atom in the union
        flat = lambda b, a: node[b * N + a]          # noqa: E731
        z = self.node_states(p, batch).reshape(B * N, -1)[real]
        x = pos.reshape(B * N, 3)[real]
        h = self.encoder(p, z, x, flat(b_in, tgt), flat(b_in, src), ea)
        b_o, i_o, j_o = torch.nonzero(mask_out, as_tuple=True)
        e_out = self.edge_features(p, d[b_o, i_o, j_o], st["tr_out"][b_o, i_o, j_o],
                                   st["tp_out"][b_o, i_o, j_o])
        hx = torch.cat([h[flat(b_o, i_o)] * h[flat(b_o, j_o)], e_out], dim=-1)
        hx = F.silu(self.lin(p, "grad_dist_mlp.layers.0", hx))
        hx = F.silu(self.lin(p, "grad_dist_mlp.layers.1", hx))
        s = torch.zeros(B, N, N, dtype=pos.dtype, device=pos.device)
        s[b_o, i_o, j_o] = self.lin(p, "grad_dist_mlp.layers.2", hx)[:, 0]
        return s, mask_out

    def score(self, p: dict, batch: dict, st: dict, pos: torch.Tensor) -> torch.Tensor:
        s, mask_out = self.pair_scores(p, batch, st, pos)
        return G.scores_to_atoms(s, pos, mask_out)

    @torch.no_grad()
    def ensemble_score(self, members: list[dict], batch: dict, st: dict,
                       pos: torch.Tensor, rows: int = 25) -> torch.Tensor:
        out = []
        for lo in range(0, pos.shape[0], rows):
            sl = slice(lo, lo + rows)
            sub = {k: v[sl] for k, v in batch.items()}
            sst = {k: v[sl] for k, v in st.items()}
            out.append(torch.stack([self.score(p, sub, sst, pos[sl]) for p in members]).mean(0))
        return torch.cat(out)


class DimeNetWalkReference(WalkReference):
    """The sampling check's reference (``check.WalkReference``) for the
    condensed network with DimeNet++: ``weights`` the program's
    ``state_dict`` of each member."""

    def __init__(self, config: dict, traffic: dict, weights: list[dict], device,
                 matmul=torch.matmul):
        self.device = device
        self.traffic = traffic
        self.dual = False
        self.net = DimeNetReference(config, matmul)
        self.params = [{k: v.detach().float().to(device) for k, v in w.items()}
                       for w in weights]
        self.clip = traffic["clip"]
        self.walk = LangevinWalk(config, traffic["n_steps"], traffic["respacing"],
                                 traffic["step_lr"])
