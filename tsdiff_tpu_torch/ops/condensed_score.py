"""Dense fused score step of one condensed-encoder model: CUDA kernel, plain
twin, and the weight extraction the score kernels share.

Replaces the TPU kernel ``tsdiff_tpu/ops/pallas/condensed_score.py::
condensed_score_pallas`` (kernel ``_score_kernel``).  Per graph, on the dense
pair rows p = i*N + j (P = N*N): the distance MLP, the R/P combine with the
precomputed bond embeddings (B, N, N, H), ``edge_cat``, L SchNet blocks
(``agg[j] = sum_i w[i, j] * xh[i]``), the output-order ``edge_cat`` and the
head MLP 2H->H->H/2->1 on ``[h_i * h_j, ea_out]``.  Output: ``edge_inv``
(B, N, N, 1) float32.  Off-edge entries are computed like the rest (on the
dummy distance 1.0 with ``cmask`` 0) and masked by the caller.

* ``extract_weights`` — one model's kernel weights from its ``state_dict``
  (``ops.packed_score.extract_weights_packed`` adds the bond table to it).
* ``condensed_score_reference`` — the plain PyTorch version, rounding to the
  working type where the TPU kernel does: after every bias add, silu and ssp
  (the first layer's ``d*w0 + b0`` is one float32 expression rounded once);
  products w*xh rounded before their float32 sum.
* ``condensed_score`` — the wrapper: CPU tensors take the plain version; CUDA
  tensors launch ``csrc/condensed_score.cu`` (built at first use) or raise.
  ``condensed_score.launches`` counts kernel launches and
  ``condensed_score_reference.calls`` plain-version calls.

What bounds the kernel on an H100 at the dense path's shapes (B=100, N=24,
H=256, L=7, bf16): 1.84e11 flop counted from the kernel body
(``condensed_score_cost``), 0.19 ms at 989 TFLOP/s, against ~125 MB of inputs,
mostly the four embedding tensors, 0.04 ms at 3.35 TB/s: the tensor cores.  The
design (one CTA per graph, ``ea`` in a global scratch streamed by 64-row
tiles, the embeddings read once into the ``de * emb`` product) is described
in the source.
"""

from __future__ import annotations

import ctypes

import torch

from tsdiff_tpu_torch.ops import schnet_stack as _stack

#: kernel weight names, in the order the CUDA entry point takes them
W_ORDER = (
    "dw0", "db0", "dw1", "db1",
    "c0r", "c0p", "c0b", "c1w", "c1b",
    "f1w", "f1b", "f2w", "f2b", "l1w", "l2w", "l2b", "ow", "ob",
    "g0h", "g0e", "g0b", "g1w", "g1b", "g2w", "g2b",
)
_STACK_MATS = ("f1w", "f2w", "l1w", "l2w", "ow")

_LIB = "condensed_score"


def _kernel_lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures declared."""
    from tsdiff_tpu_torch.ops import _build

    lib = _build.load(_LIB)
    lib.condensed_score_launch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), *[ctypes.c_int] * 5, ctypes.c_void_p,
    ]
    lib.condensed_score_launch.restype = ctypes.c_int
    lib.condensed_score_error_string.argtypes = [ctypes.c_int]
    lib.condensed_score_error_string.restype = ctypes.c_char_p
    return lib


def extract_weights(state_dict: dict) -> dict[str, torch.Tensor]:
    """One model's score-kernel weights from a condensed-encoder
    ``state_dict``, in the parameters' type: matrices in (out, in) layout (the
    layer stacks transposed from their flax (L, in, out) layout), biases as
    vectors, ``lin0`` and the head's first layer split into their halves."""
    sd = state_dict
    H = sd["edge_cat.lin1.weight"].shape[0]
    c0w = sd["edge_cat.lin0.weight"]            # (H, 2H)
    g0w = sd["grad_dist_mlp.layers.0.weight"]   # (H, 2H)
    st = {k: sd[f"encoder.stack.{k}"] for k in _stack.W_KEYS}
    w = dict(
        dw0=sd["edge_enc.mlp.layers.0.weight"].reshape(-1),
        db0=sd["edge_enc.mlp.layers.0.bias"],
        dw1=sd["edge_enc.mlp.layers.1.weight"],
        db1=sd["edge_enc.mlp.layers.1.bias"],
        c0r=c0w[:, :H], c0p=c0w[:, H:], c0b=sd["edge_cat.lin0.bias"],
        c1w=sd["edge_cat.lin1.weight"], c1b=sd["edge_cat.lin1.bias"],
        **{k: st[k].transpose(-1, -2) if k in _STACK_MATS else st[k] for k in _stack.W_KEYS},
        g0h=g0w[:, :H], g0e=g0w[:, H:], g0b=sd["grad_dist_mlp.layers.0.bias"],
        g1w=sd["grad_dist_mlp.layers.1.weight"], g1b=sd["grad_dist_mlp.layers.1.bias"],
        g2w=sd["grad_dist_mlp.layers.2.weight"].reshape(-1),
        g2b=sd["grad_dist_mlp.layers.2.bias"],
    )
    return {k: w[k].detach().contiguous() for k in W_ORDER}


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) evaluated in float32, rounded to x's type."""
    xf = x.float()
    return (xf * torch.sigmoid(xf)).to(x.dtype)


def condensed_score_reference(
    weights: dict,           # name -> tensor in the working dtype (W_ORDER layout)
    z: torch.Tensor,         # (B, N, H) node states, working dtype
    d: torch.Tensor,         # (B, N, N) float32 masked distances
    cmask: torch.Tensor,     # (B, N, N) float32 cutoff & encoder edge mask
    emb_r_in: torch.Tensor,  # (B, N, N, H) bond embeddings, working dtype
    emb_p_in: torch.Tensor,
    emb_r_out: torch.Tensor,
    emb_p_out: torch.Tensor,
    num_blocks: int,
) -> torch.Tensor:
    """Plain PyTorch dense score: (B, N, N, 1) float32.  Matrix products
    accumulate in float32 from working-dtype operands."""
    condensed_score_reference.calls += 1
    dt = z.dtype
    B, N, H = z.shape
    w = weights

    def dot(x, wt):  # x (..., in), wt (out, in) -> f32 (..., out)
        return torch.matmul(x.float(), wt.float().t())

    dv = d.to(dt).reshape(B, N * N, 1)
    de = silu((dv.float() * w["dw0"].float() + w["db0"].float()).to(dt))
    de = (dot(de, w["dw1"]) + w["db1"].float()).to(dt)          # (B, P, H)

    def edge_cat(er, ep):
        er, ep = er.reshape(B, N * N, H), ep.reshape(B, N * N, H)
        v = dot(de * er, w["c0r"]) + dot(de * ep, w["c0p"]) + w["c0b"].float()
        return (dot(silu(v.to(dt)), w["c1w"]) + w["c1b"].float()).to(dt)

    ea = edge_cat(emb_r_in, emb_p_in)
    # the SchNet stack's own plain forward, which takes (L, in, out) matrices
    stack = {k: w[k].transpose(-1, -2) if k in _STACK_MATS else w[k] for k in _stack.W_KEYS}
    if stack["f1w"].shape[0] != num_blocks:
        raise ValueError(f"num_blocks={num_blocks} but the weights hold "
                         f"{stack['f1w'].shape[0]} blocks")
    h = _stack.forward_plain(stack, z, ea, cmask.to(dt).reshape(B, N * N), store_hs=False)[0]

    ea_out = edge_cat(emb_r_out, emb_p_out)
    hh = (h[:, :, None, :] * h[:, None, :, :]).reshape(B, N * N, H)
    g = silu((dot(hh, w["g0h"]) + dot(ea_out, w["g0e"]) + w["g0b"].float()).to(dt))
    g = silu((dot(g, w["g1w"]) + w["g1b"].float()).to(dt))
    out = (g.float() * w["g2w"].float()).sum(-1) + w["g2b"].float()
    return out.reshape(B, N, N, 1)


condensed_score_reference.calls = 0


def condensed_score_cost(weights: dict, z: torch.Tensor, num_blocks: int) -> dict:
    """Work of one call, for its bound.  Flop of the matrix products, counted
    from the kernel body: 7 pair-row H x H products before and after the stack
    (the distance MLP's second layer and two ``edge_cat`` stages of three
    each), per block two pair-row and three node products, and the head's
    2H->H and H->H/2 layers.  Bytes: every input read once, the output written
    once."""
    B, N, H = z.shape
    P, L = N * N, num_blocks
    flops = 2 * B * (7 * P * H * H + L * (2 * P * H * H + 3 * N * H * H)
                     + 2 * P * H * H + P * H * (H // 2))
    t = z.element_size()
    nbytes = (
        2 * B * P * 4                       # d, cmask
        + B * N * H * t                     # z
        + 4 * B * P * H * t                 # the four embedding tensors
        + sum(v.numel() * v.element_size() for v in weights.values())
        + B * P * 4                         # output
    )
    return {"flops": flops, "bytes": nbytes}


def _check_cuda_args(weights, z, d, cmask, embs, num_blocks):
    if z.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"z must be float32 or bfloat16, got {z.dtype}")
    if z.dim() != 3 or not z.is_contiguous():
        raise ValueError("z must be a contiguous (B, N, H) tensor")
    B, N, H = z.shape
    if N % 8 or H % 64:
        raise ValueError(f"the CUDA kernel needs N % 8 == 0 and H % 64 == 0, got N={N}, H={H}")
    want = [("d", d, torch.float32, (B, N, N)), ("cmask", cmask, torch.float32, (B, N, N))]
    want += [(f"embedding {i}", e, z.dtype, (B, N, N, H)) for i, e in enumerate(embs)]
    L = num_blocks
    shapes = dict(
        dw0=(H,), db0=(H,), dw1=(H, H), db1=(H,), c0r=(H, H), c0p=(H, H), c0b=(H,),
        c1w=(H, H), c1b=(H,), f1w=(L, H, H), f1b=(L, H), f2w=(L, H, H), f2b=(L, H),
        l1w=(L, H, H), l2w=(L, H, H), l2b=(L, H), ow=(L, H, H), ob=(L, H),
        g0h=(H, H), g0e=(H, H), g0b=(H,), g1w=(H // 2, H), g1b=(H // 2,), g2w=(H // 2,),
        g2b=(1,),
    )
    want += [(f"weight {k}", weights[k], z.dtype, shapes[k]) for k in W_ORDER]
    for name, t, dtype, shape in want:
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous() \
                or t.device != z.device:
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} tensor on "
                             f"{z.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return B, N, H, L


def condensed_score(
    weights: dict,
    z: torch.Tensor,
    d: torch.Tensor,
    cmask: torch.Tensor,
    emb_r_in: torch.Tensor,
    emb_p_in: torch.Tensor,
    emb_r_out: torch.Tensor,
    emb_p_out: torch.Tensor,
    num_blocks: int,
) -> torch.Tensor:
    """``edge_inv`` (B, N, N, 1) float32 of one model.  CPU tensors take
    ``condensed_score_reference``; CUDA tensors launch the kernel on the
    current stream, or raise."""
    embs = (emb_r_in, emb_p_in, emb_r_out, emb_p_out)
    if z.device.type == "cpu":
        return condensed_score_reference(weights, z, d, cmask, *embs, num_blocks)
    if z.device.type != "cuda":
        raise ValueError(f"condensed_score runs on CPU or CUDA tensors, got {z.device}")
    B, N, H, L = _check_cuda_args(weights, z, d, cmask, embs, num_blocks)
    lib = _kernel_lib()
    out = torch.empty((B, N, N, 1), dtype=torch.float32, device=z.device)
    ea = torch.empty((B, N * N, H), dtype=z.dtype, device=z.device)
    tensors = [d, cmask, z, *embs, *(weights[k] for k in W_ORDER), ea, out]
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    stream = torch.cuda.current_stream(z.device).cuda_stream
    with torch.cuda.device(z.device):
        err = lib.condensed_score_launch(ptrs, B, N, H, L, int(z.dtype == torch.bfloat16), stream)
    if err != 0:
        msg = lib.condensed_score_error_string(err).decode()
        raise RuntimeError(
            f"condensed_score kernel launch failed ({err}: {msg}) at B={B} N={N} H={H} "
            f"dtype={z.dtype}"
        )
    condensed_score.launches += 1
    return out


condensed_score.launches = 0
