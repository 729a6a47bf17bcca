"""Offset-packed fused score step for an ensemble: CUDA kernel, plain twin,
and the weight extraction they share.

Replaces the TPU kernel ``tsdiff_tpu/ops/pallas/condensed_score_packed.py::
packed_score_pallas`` (kernel ``_score_kernel``), one launch for all M
members instead of one call per member.  Per packed pair row (k, i) = the
pair {i, (i+k) % N} of each graph, and per member: the distance MLP, the
bond embeddings (row reads of the embedding table), ``edge_cat``, L SchNet
blocks with the symmetric roll aggregation, the output-order ``edge_cat`` and
the head MLP 2H->H->H/2->1 on ``[h_i * h_j, ea_out]``.  Output: packed
``edge_inv`` (M, B, K, N) float32.

* ``packed_score_reference`` — the plain PyTorch version, rounding to the
  working type at the same points as the TPU kernel (after every bias add,
  silu and ssp; products w*xh rounded before their f32 sum).
* ``packed_score`` — the wrapper: for CPU tensors it takes the plain
  version; for CUDA tensors it launches ``csrc/packed_score.cu`` (built at
  first use) or raises.  ``packed_score.launches`` counts kernel launches and
  ``packed_score_reference.calls`` counts plain-version calls.

What bounds the kernel on an H100 at the main path's shapes (M=8 members,
B=100 graphs, N=24, H=F=256, L=7, bf16): the work counted as in
``condensed_score_packed.py:222-228`` minus its one-hot term (4*128*H per
row, a row read here) is ~7.6e11 flop per launch against ~56 MB of inputs
and outputs (mostly the members' weights), so the tensor-core rate bounds
it: ~0.77 ms at 989 TFLOP/s, against ~17 us for the bytes at 3.35 TB/s.  The design keeps node states
and the aggregation in shared memory (one CTA per member and graph), runs
the bf16 products on the tensor cores (mma.sync) and streams the weights
from L2; see the source's header for what it leaves to later work.
"""

from __future__ import annotations

import ctypes

import torch

from tsdiff_tpu_torch.ops.condensed_score import W_ORDER as _DENSE_ORDER
from tsdiff_tpu_torch.ops.condensed_score import extract_weights
from tsdiff_tpu_torch.ops.condensed_score import silu as _silu
from tsdiff_tpu_torch.ops.schnet_stack import ssp

#: kernel weight names, in the order the CUDA entry point takes them
W_ORDER = ("table", *_DENSE_ORDER)

_LIB = "packed_score"


def _kernel_lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures declared."""
    from tsdiff_tpu_torch.ops import _build

    lib = _build.load(_LIB)
    lib.packed_score_launch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), *[ctypes.c_int] * 7, ctypes.c_void_p,
    ]
    lib.packed_score_launch.restype = ctypes.c_int
    lib.packed_score_error_string.argtypes = [ctypes.c_int]
    lib.packed_score_error_string.restype = ctypes.c_char_p
    return lib


def extract_weights_packed(state_dict: dict) -> dict[str, torch.Tensor]:
    """One member's kernel weights from a condensed-encoder ``state_dict``:
    the dense score kernel's extraction (matrices in (out, in) layout, biases
    as vectors) plus the bond embedding table as it is (no padding: the
    kernel reads rows)."""
    w = extract_weights(state_dict)
    w["table"] = state_dict["edge_enc.bond_emb.weight"].detach().contiguous()
    return {k: w[k] for k in W_ORDER}


def packed_score_reference(
    weights: dict,        # name -> (M, ...) in the working dtype (W_ORDER layout)
    z: torch.Tensor,      # (M, B, N, H) node states, working dtype
    d: torch.Tensor,      # (B, K, N) float32 masked packed distances
    cmask: torch.Tensor,  # (B, K, N) float32 cutoff & encoder mask & 0.5 last slab
    type_r_in: torch.Tensor,   # (B, K, N) int32
    type_p_in: torch.Tensor,
    type_r_out: torch.Tensor,
    type_p_out: torch.Tensor,
    num_blocks: int,
) -> torch.Tensor:
    """Plain PyTorch packed score for M members: (M, B, K, N) float32.
    Matrix products accumulate in float32 from working-dtype operands."""
    packed_score_reference.calls += 1
    dt = z.dtype
    M = z.shape[0]
    B, K, N = d.shape
    w = weights

    def dot(x, wt):  # x (M, ..., in), wt (M, out, in) -> f32 (M, ..., out)
        flat = x.float().reshape(M, -1, x.shape[-1])
        out = torch.matmul(flat, wt.float().transpose(1, 2))
        return out.reshape(*x.shape[:-1], wt.shape[1])

    def row(v, nd):  # (M, F) -> (M, 1, ..., 1, F) broadcasting over nd middle dims
        return v.reshape(v.shape[0], *([1] * nd), v.shape[-1])

    h = z                                          # (M, B, N, H)
    dv = d.to(dt)[None, ..., None]                 # (1, B, K, N, 1)
    c = cmask.to(dt)[None, ..., None]
    de = _silu(dv * row(w["dw0"], 3) + row(w["db0"], 3))
    de = (dot(de, w["dw1"]) + row(w["db1"], 3).float()).to(dt)   # (M, B, K, N, H)

    def edge_cat(tr, tp):
        er = w["table"][:, tr.long()]              # (M, B, K, N, H)
        ep = w["table"][:, tp.long()]
        v = dot(de * er, w["c0r"]) + dot(de * ep, w["c0p"]) + row(w["c0b"], 3).float()
        v = _silu(v.to(dt))
        return (dot(v, w["c1w"]) + row(w["c1b"], 3).float()).to(dt)

    ea = edge_cat(type_r_in, type_p_in)
    for l in range(num_blocks):
        f = ssp((dot(ea, w["f1w"][:, l]) + row(w["f1b"][:, l], 3).float()).to(dt))
        f = (dot(f, w["f2w"][:, l]) + row(w["f2b"][:, l], 3).float()).to(dt) * c
        xh = dot(h, w["l1w"][:, l]).to(dt)         # (M, B, N, F)
        agg = torch.zeros(xh.shape, dtype=torch.float32, device=xh.device)
        for k in range(1, K + 1):
            fk = f[:, :, k - 1]
            agg = agg + torch.roll(fk * xh, k, dims=2).float()
            agg = agg + (fk * torch.roll(xh, -k, dims=2)).float()
        conv = (dot(agg.to(dt), w["l2w"][:, l]) + row(w["l2b"][:, l], 2).float()).to(dt)
        h = h + (dot(ssp(conv), w["ow"][:, l]) + row(w["ob"][:, l], 2).float()).to(dt)

    ea_out = edge_cat(type_r_out, type_p_out)
    hh = torch.stack([h * torch.roll(h, -k, dims=2) for k in range(1, K + 1)], dim=2)
    g = dot(hh, w["g0h"]) + dot(ea_out, w["g0e"]) + row(w["g0b"], 3).float()
    g = _silu(g.to(dt))
    g = _silu((dot(g, w["g1w"]) + row(w["g1b"], 3).float()).to(dt))
    out = (g.float() * row(w["g2w"], 3).float()).sum(-1) + w["g2b"].float().reshape(M, 1, 1, 1)
    return out


packed_score_reference.calls = 0


def packed_score_cost(weights: dict, z: torch.Tensor, num_blocks: int) -> dict:
    """Work of one call, for its bound: the flop of the matrix products
    (counted as the TPU kernel's cost estimate, minus its one-hot embedding
    term) and the bytes of its inputs read once and its output written once."""
    M, B, N, H = z.shape
    R, F, L = (N // 2) * N, H, num_blocks
    flops = 2 * M * B * R * (
        H * H + 2 * 3 * H * H + L * (H * F + F * F) + 2 * H * H + H * (H // 2)
    ) + 2 * M * B * L * N * (H * F + F * H + H * H)
    nbytes = (
        6 * B * R * 4                       # d, cmask, 4 type tensors
        + z.numel() * z.element_size()
        + sum(t.numel() * t.element_size() for t in weights.values())
        + M * B * R * 4                     # output
    )
    return {"flops": flops, "bytes": nbytes}


def _check_cuda_args(weights, z, d, cmask, types, num_blocks):
    if z.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"z must be float32 or bfloat16, got {z.dtype}")
    if z.dim() != 4 or not z.is_contiguous():
        raise ValueError("z must be a contiguous (M, B, N, H) tensor")
    M, B, N, H = z.shape
    K = N // 2
    if N % 8 or H % 64:
        raise ValueError(f"the CUDA kernel needs N % 8 == 0 and H % 64 == 0, got N={N}, H={H}")
    for name, t, dtype in (("d", d, torch.float32), ("cmask", cmask, torch.float32),
                           *[(f"types[{i}]", t, torch.int32) for i, t in enumerate(types)]):
        if t.shape != (B, K, N) or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} ({B}, {K}, {N}) tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != z.device:
            raise ValueError(f"{name} is on {t.device}, z on {z.device}")
    L, V = num_blocks, weights["table"].shape[1]
    shapes = dict(
        table=(V, H), dw0=(H,), db0=(H,), dw1=(H, H), db1=(H,), c0r=(H, H), c0p=(H, H),
        c0b=(H,), c1w=(H, H), c1b=(H,), f1w=(L, H, H), f1b=(L, H), f2w=(L, H, H),
        f2b=(L, H), l1w=(L, H, H), l2w=(L, H, H), l2b=(L, H), ow=(L, H, H), ob=(L, H),
        g0h=(H, H), g0e=(H, H), g0b=(H,), g1w=(H // 2, H), g1b=(H // 2,), g2w=(H // 2,),
        g2b=(1,),
    )
    for k in W_ORDER:
        t = weights[k]
        if tuple(t.shape) != (M, *shapes[k]) or t.dtype != z.dtype or not t.is_contiguous() \
                or t.device != z.device:
            raise ValueError(f"weight {k} must be a contiguous {z.dtype} {(M, *shapes[k])} "
                             f"tensor on {z.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return M, B, N, H, L, V


def packed_score(
    weights: dict,
    z: torch.Tensor,
    d: torch.Tensor,
    cmask: torch.Tensor,
    type_r_in: torch.Tensor,
    type_p_in: torch.Tensor,
    type_r_out: torch.Tensor,
    type_p_out: torch.Tensor,
    num_blocks: int,
) -> torch.Tensor:
    """Packed ``edge_inv`` (M, B, K, N) float32 for M members.  CPU tensors
    take ``packed_score_reference``; CUDA tensors launch the kernel on the
    current stream, or raise."""
    types = (type_r_in, type_p_in, type_r_out, type_p_out)
    if z.device.type == "cpu":
        return packed_score_reference(weights, z, d, cmask, *types, num_blocks)
    if z.device.type != "cuda":
        raise ValueError(f"packed_score runs on CPU or CUDA tensors, got {z.device}")
    M, B, N, H, L, V = _check_cuda_args(weights, z, d, cmask, types, num_blocks)
    lib = _kernel_lib()
    K = N // 2
    out = torch.empty((M, B, K, N), dtype=torch.float32, device=z.device)
    ea = torch.empty((M * B, K * N, H), dtype=z.dtype, device=z.device)
    tensors = [d, cmask, z, *types, *(weights[k] for k in W_ORDER), ea, out]
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    stream = torch.cuda.current_stream(z.device).cuda_stream
    with torch.cuda.device(z.device):
        err = lib.packed_score_launch(
            ptrs, M, B, N, H, L, V, int(z.dtype == torch.bfloat16), stream
        )
    if err != 0:
        msg = lib.packed_score_error_string(err).decode()
        raise RuntimeError(
            f"packed_score kernel launch failed ({err}: {msg}) at M={M} B={B} N={N} H={H} "
            f"dtype={z.dtype}"
        )
    packed_score.launches += 1
    return out


packed_score.launches = 0
