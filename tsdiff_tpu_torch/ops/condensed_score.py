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
  ``condensed_score.launches`` counts kernel launches,
  ``condensed_score.wg_launches`` those of the warp-specialised kernel, and
  ``condensed_score_reference.calls`` plain-version calls.

What bounds the kernel on an H100 at the dense path's shapes (B=100, N=24,
H=256, L=7, bf16): 1.84e11 flop counted from the kernel body
(``condensed_score_cost``), 0.19 ms at 989 TFLOP/s, against ~125 MB of inputs,
mostly the four embedding tensors, 0.04 ms at 3.35 TB/s: the tensor cores.

Two kernels live in ``csrc/condensed_score.cu``.  bfloat16 at H = 256 and
N <= 24 takes the warp-specialised ``wgmma`` one (``csrc/wg_pipeline.cuh``,
as the packed score kernel): it reads the matrices from ``weights[WG_IMAGE]``,
the tile images ``with_wg_image`` makes once (the packed kernel's image of
the same matrices), and raises without them.  float32 and other shapes take
the first port's ``mma.sync`` kernel, by the explicit branch in
``condensed_score_launch``.  ``condensed_score.wg_launches`` counts the
former's launches.  The host side of the ``wgmma`` kernel is stated here for
the tests: its dense row table (``dense_row_pairs``), its static schedule of
weight stages (``dense_schedule``) with its L2 weight bytes, and its
fixed-order aggregation (``aggregate_dense_by_node``).  The design is in the
source's header.
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
# The warp-specialised score kernels (this one and ops/packed_score.py's):
#: the arranged entry of a weight dictionary
WG_IMAGE = "wg_image"
#: rows of a pair-row tile
TILE_ROWS = 64
#: output columns (weight rows) of one stage of the kernels' shared-memory ring
STAGE_COLS = 32
#: bytes of one weight stage: STAGE_COLS rows of K = 256 bf16 values
STAGE_BYTES = 16384

_LIB = "condensed_score"


def _kernel_lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures declared."""
    from tsdiff_tpu_torch.ops import _build

    lib = _build.load(_LIB)
    lib.condensed_score_launch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), *[ctypes.c_int] * 5, ctypes.c_void_p,
    ]
    lib.condensed_score_launch.restype = ctypes.c_int
    lib.condensed_score_uses_wg.argtypes = [ctypes.c_int] * 3
    lib.condensed_score_uses_wg.restype = ctypes.c_int
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


# ---------------------------------------------------------------------------
# The warp-specialised kernel's host side.


def with_wg_image(weights: dict) -> dict[str, torch.Tensor]:
    """``weights`` with the arranged entry ``WG_IMAGE``: the matrices of
    ``ops.packed_score.IMAGE_ORDER`` as the tile images a warp-specialised
    kernel's producer copies into its shared-memory ring
    (``ops.packed_score.arrange_weights``).  The dense and the packed kernels
    read the same image; the bond table is not part of it."""
    from tsdiff_tpu_torch.ops.packed_score import arrange_weights

    return {**weights, WG_IMAGE: arrange_weights(weights)}


def stage_schedule(tile_pairs: int, num_blocks: int) -> list[tuple[str, int, int]]:
    """The static schedule of weight stages every CTA of a warp-specialised
    score kernel walks, producer and consumers alike: ``(matrix, layer,
    32-column block)`` per stage, for ``tile_pairs`` pairs of 64-row tiles (a
    stage feeds both tiles of a pair, one per consumer warpgroup).  Per tile
    pair the encoder-order ``edge_cat`` (dw1; c0r and c0p stage by stage;
    c1w), per block the node product l1w, f1w and f2w per tile pair, the
    node products l2w and ow, and per tile pair the head (``edge_cat``; g0h
    and g0e stage by stage; half a g1w)."""
    blocks = range(256 // STAGE_COLS)
    edge_cat = ([("dw1", 0, c) for c in blocks]
                + [(k, 0, c) for c in blocks for k in ("c0r", "c0p")]
                + [("c1w", 0, c) for c in blocks])
    sched = edge_cat * tile_pairs
    for l in range(num_blocks):
        sched += [("l1w", l, c) for c in blocks]
        sched += [(k, l, c) for k in ("f1w", "f2w") for c in blocks] * tile_pairs
        sched += [(k, l, c) for k in ("l2w", "ow") for c in blocks]
    head = (edge_cat + [(k, 0, c) for c in blocks for k in ("g0h", "g0e")]
            + [("g1w", 0, c) for c in range(128 // STAGE_COLS)])
    return sched + head * tile_pairs


def dense_tile_pairs(N: int) -> int:
    """Tile pairs of one graph's P = N*N dense pair rows (N % 8 == 0 makes P
    a multiple of 64: every tile is full, and only an odd tile count leaves
    the second warpgroup of the last pair idle)."""
    return (-(-(N * N) // TILE_ROWS) + 1) // 2


def dense_schedule(N: int, num_blocks: int) -> list[tuple[str, int, int]]:
    """The ``wgmma`` dense kernel's schedule of weight stages per CTA."""
    return stage_schedule(dense_tile_pairs(N), num_blocks)


def wg_dense_l2_weight_bytes(B: int, N: int, num_blocks: int) -> int:
    """Weight bytes one launch of the ``wgmma`` kernel reads from L2: one
    16 KB stage per schedule entry and CTA (one CTA per graph)."""
    return B * len(dense_schedule(N, num_blocks)) * STAGE_BYTES


def mma_sync_dense_l2_weight_bytes(B: int, N: int, num_blocks: int, H: int = 256,
                                   itemsize: int = 2) -> int:
    """The same for the ``mma.sync`` kernel, which reads every matrix once
    per 64-row tile: per tile 8 matrices of ``edge_cat`` (encoder and output
    order), 2 per block and the head's 2.5, and 3 node products per block."""
    tiles = -(-(N * N) // TILE_ROWS)
    return int(B * (tiles * (8 + 2 * num_blocks + 2.5) + 3 * num_blocks) * H * H * itemsize)


def dense_row_pairs(N: int) -> torch.Tensor:
    """``(N*N, 2)`` int64: the atoms ``(i, j)`` of every dense pair row
    ``p = i*N + j``, as the kernel tabulates them once per CTA (no division
    per row afterwards)."""
    p = torch.arange(N * N)
    return torch.stack([p // N, p % N], dim=1)


def aggregate_dense_by_node(w: torch.Tensor, xh: torch.Tensor) -> torch.Tensor:
    """The kernel's dense aggregation, stated per receiving node in its
    order: ``agg[j] = sum_i rnd(w[i*N + j] * xh[i])``, sources ``i``
    ascending, for ``w (N*N, F)`` and ``xh (N, F)`` in the working type,
    products rounded to it, summed in float32.  Equal to the plain
    version's sum up to the order of the float32 additions."""
    N = xh.shape[0]
    w3 = w.reshape(N, N, -1)
    agg = torch.zeros(xh.shape, dtype=torch.float32)
    for i in range(N):
        agg = agg + (w3[i] * xh[i]).float()
    return agg


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
    once (the arranged copy of the matrices, ``WG_IMAGE``, is not a second
    input)."""
    B, N, H = z.shape
    P, L = N * N, num_blocks
    flops = 2 * B * (7 * P * H * H + L * (2 * P * H * H + 3 * N * H * H)
                     + 2 * P * H * H + P * H * (H // 2))
    t = z.element_size()
    nbytes = (
        2 * B * P * 4                       # d, cmask
        + B * N * H * t                     # z
        + 4 * B * P * H * t                 # the four embedding tensors
        + sum(v.numel() * v.element_size() for k, v in weights.items() if k != WG_IMAGE)
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


def _check_image(weights, L, H, z) -> torch.Tensor:
    image = weights.get(WG_IMAGE)
    n = (13 + 10 * L) * (H * H // 2)
    if image is None:
        raise ValueError(f"this shape takes the warp-specialised kernel, which needs the "
                         f"arranged weights[{WG_IMAGE!r}] (with_wg_image)")
    if tuple(image.shape) != (n,) or image.dtype != z.dtype or not image.is_contiguous() \
            or image.device != z.device:
        raise ValueError(f"weights[{WG_IMAGE!r}] must be a contiguous {z.dtype} ({n},) tensor "
                         f"on {z.device}, got {image.dtype} {tuple(image.shape)} on {image.device}")
    return image


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
    ``condensed_score_reference``; CUDA tensors launch a kernel on the
    current stream, or raise.

    Which kernel is decided by the shape alone, in ``condensed_score_launch``:
    bfloat16 at H = 256 with N <= 24 takes the warp-specialised ``wgmma``
    kernel, which needs ``weights[WG_IMAGE]`` (``with_wg_image``) and raises
    without it; float32 and other shapes take the ``mma.sync`` kernel.
    Neither gives way to the other, or to the plain version, when it fails."""
    embs = (emb_r_in, emb_p_in, emb_r_out, emb_p_out)
    if z.device.type == "cpu":
        return condensed_score_reference(weights, z, d, cmask, *embs, num_blocks)
    if z.device.type != "cuda":
        raise ValueError(f"condensed_score runs on CPU or CUDA tensors, got {z.device}")
    B, N, H, L = _check_cuda_args(weights, z, d, cmask, embs, num_blocks)
    lib = _kernel_lib()
    use_wg = bool(lib.condensed_score_uses_wg(N, H, int(z.dtype == torch.bfloat16)))
    out = torch.empty((B, N, N, 1), dtype=torch.float32, device=z.device)
    if use_wg:
        image = _check_image(weights, L, H, z)
        # the kernel's own scratch: per graph ea as 64-row tile images, then one
        # tile image per consumer warpgroup for results kept while a product
        # still reads their tile
        ea = torch.empty((B, N * N // TILE_ROWS + 2, TILE_ROWS * H), dtype=z.dtype,
                         device=z.device)
    else:
        image = None
        ea = torch.empty((B, N * N, H), dtype=z.dtype, device=z.device)
    tensors = [d, cmask, z, *embs, *(weights[k] for k in W_ORDER), image, ea, out]
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])
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
    condensed_score.wg_launches += int(use_wg)
    return out


condensed_score.launches = 0
condensed_score.wg_launches = 0
