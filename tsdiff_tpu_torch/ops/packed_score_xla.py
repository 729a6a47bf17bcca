"""Differentiable offset-packed score of one model, in torch ops: the packed
training forward.

Port of ``tsdiff_tpu/ops/packed_score_xla.py::packed_score_xla``, which is
plain XLA in the JAX package (no TPU kernel behind it), so its port is torch
ops: the matrix products go to cuBLAS.  Per packed pair row (k, i), the pair
{i, (i+k) % N}: the distance MLP, the bond embeddings, ``edge_cat``, L SchNet
blocks with the symmetric aggregation, the output-order ``edge_cat`` and the
head on ``[h_i * h_j, ea_out]``.  Output: packed ``edge_inv`` (B, K, N)
float32, with a gradient to every weight and to ``z``.

It rounds where the XLA twin rounds: in bfloat16 after every product and
again after every bias add (not once after a float32 bias add, as the fused
kernels' plain twins do); ``silu`` and ``ssp`` are evaluated in float32 and
rounded, through ``F.silu`` and ``F.softplus`` (fewer launches than the
twin's formulas, the same values to float32 rounding).  In float32 the two
coincide.

Three choices keep the step's launches and its backward cheap:

* the weights are the module's own parameters (``packed_xla_weights``), never
  a detached extraction, so the gradients reach them;
* the bond embeddings are ``F.embedding`` gathers, whose backward reduces a
  type's many repeats in parallel (``weight[index]``'s backward runs them in
  one serial pass);
* the aggregation over the K offsets is two gathers, not 2K rolls: with the
  index tables ``(i - k) mod N`` and ``(i + k) mod N``
  (``core.packed.offset_index_tables``) each direction is one
  ``index_select`` over all k, and its backward another gather, not
  ``index_select``'s atomic scatter.  The products are rounded to the
  working type before their float32 sum, as in the twin; the float32
  summation order differs from its sequential one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from tsdiff_tpu_torch.core.packed import offset_index_tables

_LOG2 = math.log(2.0)


def _silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.float()).to(x.dtype)


def _ssp(x: torch.Tensor) -> torch.Tensor:
    return (F.softplus(x.float()) - _LOG2).to(x.dtype)


class _RollIn(torch.autograd.Function):
    """(B, K, N, F) -> (B, K, N, F): ``roll(x_k, k)`` along N for every k, one
    gather; its backward gathers through the inverse permutation (no atomics)."""

    @staticmethod
    def forward(ctx, x, minus, unroll):
        ctx.save_for_backward(unroll)
        b, k, n, f = x.shape
        return x.reshape(b, k * n, f).index_select(1, minus).reshape(b, k, n, f)

    @staticmethod
    def backward(ctx, g):
        (unroll,) = ctx.saved_tensors
        b, k, n, f = g.shape
        return g.reshape(b, k * n, f).index_select(1, unroll).reshape(b, k, n, f), None, None


class _RollOut(torch.autograd.Function):
    """(B, N, F) -> (B, K, N, F): ``roll(x, -k)`` for every k, one gather; its
    backward sums the K cotangents of a node, gathered back (no atomics)."""

    @staticmethod
    def forward(ctx, x, minus, plus):
        ctx.save_for_backward(minus)
        b, n, f = x.shape
        return x.index_select(1, plus).reshape(b, n // 2, n, f)

    @staticmethod
    def backward(ctx, g):
        (minus,) = ctx.saved_tensors
        b, k, n, f = g.shape
        back = g.reshape(b, k * n, f).index_select(1, minus).reshape(b, k, n, f)
        return back.sum(1), None, None


def packed_score_xla(
    weights: dict,        # packed_xla_weights: (in, out) matrices, float32 parameters
    z: torch.Tensor,      # (B, N, H) node states
    d: torch.Tensor,      # (B, K, N) masked packed distances
    cmask: torch.Tensor,  # (B, K, N) float cutoff & encoder mask & 0.5-slab
    type_r_in: torch.Tensor,   # (B, K, N) int32
    type_p_in: torch.Tensor,
    type_r_out: torch.Tensor,
    type_p_out: torch.Tensor,
    num_blocks: int,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Packed edge_inv (B, K, N) float32, differentiable w.r.t. ``weights`` and ``z``."""
    B, K, N = d.shape
    w = {k: v.to(dtype) for k, v in weights.items()}
    h = z.to(dtype)
    dv = d[..., None].to(dtype)                    # (B, K, N, 1)
    c = cmask[..., None].to(dtype)
    minus, plus, unroll = offset_index_tables(N, d.device)
    table = w["table"]

    de = _silu(dv * w["dw0"][0] + w["db0"])
    de = de @ w["dw1"] + w["db1"]                  # (B, K, N, H)

    def edge_cat(tr, tp):
        er = F.embedding(tr, table)
        ep = F.embedding(tp, table)
        v = _silu((de * er) @ w["c0r"] + (de * ep) @ w["c0p"] + w["c0b"])
        return v @ w["c1w"] + w["c1b"]

    ea = edge_cat(type_r_in, type_p_in)

    for l in range(num_blocks):
        f = _ssp(ea @ w["f1w"][l] + w["f1b"][l])
        f = (f @ w["f2w"][l] + w["f2b"][l]) * c   # (B, K, N, F)
        xh = h @ w["l1w"][l]                       # (B, N, F)
        # roll(f_k * xh, k) and f_k * roll(xh, -k) for every k, the products
        # rounded to the working type before their float32 sum
        t_in = _RollIn.apply(f * xh[:, None], minus, unroll)
        t_out = f * _RollOut.apply(xh, minus, plus)
        agg = torch.sum(t_in, 1, dtype=torch.float32) + torch.sum(t_out, 1, dtype=torch.float32)
        conv = agg.to(dtype) @ w["l2w"][l] + w["l2b"][l]
        h = h + _ssp(conv) @ w["ow"][l] + w["ob"][l]

    ea_out = edge_cat(type_r_out, type_p_out)

    hh = h[:, None] * _RollOut.apply(h, minus, plus)      # h_i * h_{i+k}
    g = _silu(hh @ w["g0h"] + ea_out @ w["g0e"] + w["g0b"])
    g = _silu(g @ w["g1w"] + w["g1b"])
    return (g @ w["g2w"] + w["g2b"])[..., 0].float()
