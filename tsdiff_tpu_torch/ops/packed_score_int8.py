"""Offset-packed fused score step with int8 pair-row products: CUDA kernel,
plain twin and the quantizing weight extraction.

Replaces the TPU kernel ``tsdiff_tpu/ops/pallas/condensed_score_packed_int8.py
::packed_score_pallas_int8`` (kernel ``_score_kernel_int8``), one launch for
all M members.  It is the program of ``ops.packed_score`` on the same packed
pair rows, with

* the weights of every pair-row product (``QUANTIZED``) as symmetric int8
  codes, one float32 scale per tensor (``SCALED``, per layer for ``f1w`` and
  ``f2w``): ``s = max(|w|, 1e-12) / 127``, ``q = round(w / s)`` with ties to
  even, computed from the float32 parameters;
* the activation of every such product quantized per row right before it,
  from its value in the working type, ``ea`` once for all L blocks;
* the exact int32 sum scaled by ``s_row * s_w`` (that product first), then
  the bias in float32, then the rounding to the working type;
* a bond embedding as a row of the int8 table times the table's scale;
* the 1->H first layer, the node products, the aggregation, ``h`` and the
  head's last layer left in the working type.

``packed_score_int8_reference`` is the plain PyTorch version,
``packed_score_int8`` the wrapper (CPU tensors take the plain version; CUDA
tensors launch ``csrc/packed_score_int8.cu``, built at first use, or raise);
``.calls`` and ``.launches`` count them.  As in ``ops.packed_score`` the
source holds two kernels: bfloat16 at H = 256 and N <= 24 takes the
warp-specialised ``wgmma`` one (s8 products from a shared-memory ring of
weight stages, the quantization in the producing product's epilogue), which
reads the matrices from the arranged entries ``WG_IMAGE8`` and ``WG_IMAGE``
(``with_wg_images_int8``); float32 and every other shape take the first
port's ``mma.sync`` kernel.  ``.wg_launches`` counts the former's launches.

What bounds the kernel on an H100 at the main path's shapes (M=8, B=100,
N=24, H=F=256, L=7, bf16): 7.1e11 int8 operations in the pair-row products,
0.36 ms at 1979 TOP/s, plus 5.3e10 flop of node products and the last head
layer, 0.05 ms at 989 TFLOP/s bf16, against ~35 MB of inputs and outputs:
the tensor cores (``packed_score_int8_cost``).
"""

from __future__ import annotations

import ctypes

import torch

from tsdiff_tpu_torch.ops.condensed_score import silu as _silu
from tsdiff_tpu_torch.ops.condensed_score import stage_schedule
from tsdiff_tpu_torch.ops.packed_score import (
    STAGE_BYTES,
    TILE_ROWS,
    W_ORDER,
    WG_IMAGE,
    extract_weights_packed,
    packed_score_cost,
    tile_image,
    tile_image_inverse,
    wg_tile_pairs,
)
from tsdiff_tpu_torch.ops.schnet_stack import ssp

#: per-tensor-quantized weights, in the order of their scales in ``scales``
SCALED = ("dw1", "c0r", "c0p", "c1w", "g0h", "g0e", "g1w", "table")
#: every weight that is int8 codes
QUANTIZED = (*SCALED, "f1w", "f2w")
#: the float32 scale tensors, in the order the CUDA entry point takes them
SCALE_KEYS = ("scales", "f1w_s", "f2w_s")
#: the arranged entries of a weight dictionary: the int8 matrices' tile images
#: (``WG_IMAGE8``) and the node products' working-type ones (``WG_IMAGE``)
WG_IMAGE8 = "wg_image8"
#: matrices of the two images, in the order ``csrc/packed_score_int8.cu::WImage8``
#: reads them; the layer-stacked ones hold their L layers one after another
IMAGE8_ORDER = ("dw1", "c0r", "c0p", "c1w", "f1w", "f2w", "g0h", "g0e", "g1w")
NODE_IMAGE_ORDER = ("l1w", "l2w", "ow")

_LIB = "packed_score_int8"


def _kernel_lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures declared."""
    from tsdiff_tpu_torch.ops import _build

    lib = _build.load(_LIB)
    lib.packed_score_int8_launch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), *[ctypes.c_int] * 7, ctypes.c_void_p,
    ]
    lib.packed_score_int8_launch.restype = ctypes.c_int
    lib.packed_score_int8_uses_wg.argtypes = [ctypes.c_int] * 3
    lib.packed_score_int8_uses_wg.restype = ctypes.c_int
    lib.packed_score_int8_tile_selftest.argtypes = [ctypes.c_void_p] * 4
    lib.packed_score_int8_tile_selftest.restype = ctypes.c_int
    lib.packed_score_int8_error_string.argtypes = [ctypes.c_int]
    lib.packed_score_int8_error_string.restype = ctypes.c_char_p
    return lib


def _quant_tensor(w: torch.Tensor, per_layer: bool):
    """Symmetric int8 codes and scale(s) of a float32 tensor: one scale, or
    one per leading index."""
    wf = w.float()
    amax = wf.abs().amax(dim=tuple(range(1, wf.dim()))) if per_layer else wf.abs().max()
    s = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.round(wf / s.reshape(-1, *[1] * (wf.dim() - 1)) if per_layer else wf / s)
    return q.to(torch.int8), s


def extract_weights_packed_int8(state_dict: dict) -> dict[str, torch.Tensor]:
    """``extract_weights_packed`` with the pair-row products' weights
    quantized from the float32 parameters: the ``QUANTIZED`` entries are int8
    codes (same (out, in) layouts), ``scales`` (8,) float32 holds the
    per-tensor scales in ``SCALED`` order, ``f1w_s`` and ``f2w_s`` (L,) the
    per-layer ones.  The other entries stay in the parameters' type."""
    w = dict(extract_weights_packed(state_dict))
    scales = []
    for k in SCALED:
        w[k], s = _quant_tensor(w[k], per_layer=False)
        scales.append(s)
    w["scales"] = torch.stack(scales)
    for k in ("f1w", "f2w"):
        w[k], w[k + "_s"] = _quant_tensor(w[k], per_layer=True)
    return {k: v.contiguous() for k, v in w.items()}


def cast_unquantized(weights: dict, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """The weights with every entry that is not int8 codes or a scale cast to
    the working dtype."""
    keep = set(QUANTIZED) | set(SCALE_KEYS) | {WG_IMAGE8}
    return {k: v if k in keep else v.to(dtype).contiguous() for k, v in weights.items()}


def arrange_weights_int8(weights: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """``(int8 image, working-type image)`` of int8 kernel weights, one member's
    or stacked: the codes of ``IMAGE8_ORDER`` and the node matrices of
    ``NODE_IMAGE_ORDER`` as tile images (``ops.packed_score.tile_image``, 32-row
    blocks; an int8 ring stage is two of them, 64 output columns), each flat.
    Made once, when the weight dictionary is built."""
    lead = weights["dw1"].dim() - 2
    cat = lambda keys: torch.cat([tile_image(weights[k]).flatten(lead) for k in keys], dim=-1)
    return cat(IMAGE8_ORDER), cat(NODE_IMAGE_ORDER)


def split_images_int8(image8: torch.Tensor, image: torch.Tensor, num_blocks: int,
                      H: int = 256) -> dict[str, torch.Tensor]:
    """The matrices back from ``arrange_weights_int8``'s tensors: its inverse."""
    out, L = {}, num_blocks
    for img, keys in ((image8, IMAGE8_ORDER), (image, NODE_IMAGE_ORDER)):
        pos = 0
        for k in keys:
            shape = (H // 2, H) if k == "g1w" else (H, H) if k in SCALED else (L, H, H)
            n = 1
            for v in shape:
                n *= v
            flat = img[..., pos:pos + n].reshape(*img.shape[:-1], *shape[:-2], shape[-2] * shape[-1])
            out[k] = tile_image_inverse(flat, shape[-2], shape[-1])
            pos += n
    return out


def with_wg_images_int8(weights: dict) -> dict[str, torch.Tensor]:
    """``weights`` with the arranged entries ``WG_IMAGE8`` and ``WG_IMAGE`` added."""
    image8, image = arrange_weights_int8(weights)
    return {**weights, WG_IMAGE8: image8, WG_IMAGE: image}


def wg_schedule_int8(N: int, num_blocks: int) -> list[tuple[str, int, int]]:
    """The static schedule of 16 KB weight stages of the warp-specialised int8
    kernel: ``ops.condensed_score.stage_schedule`` over B1's tile pairs with
    the int8 matrices in stages of 64 output columns (half as many stages) and
    the node matrices, in the working type, in stages of 32."""
    sched = []
    for name, l, c in stage_schedule(wg_tile_pairs(N), num_blocks):
        if name in NODE_IMAGE_ORDER:
            sched.append((name, l, c))
        elif c % 2 == 0:
            sched.append((name, l, c // 2))
    return sched


def wg_l2_weight_bytes_int8(M: int, B: int, N: int, num_blocks: int) -> int:
    """Weight bytes one launch of the warp-specialised int8 kernel reads from L2."""
    return M * B * len(wg_schedule_int8(N, num_blocks)) * STAGE_BYTES


def mma_sync_l2_weight_bytes_int8(M: int, B: int, N: int, num_blocks: int, H: int = 256) -> int:
    """The same for the ``mma.sync`` int8 kernel: every matrix once per 64-row
    tile, the pair-row ones in one byte an element, the node ones in two."""
    tiles = -(-((N // 2) * N) // TILE_ROWS)
    return int(M * B * H * H * (tiles * (8 + 2 * num_blocks + 2.5) + 2 * 3 * num_blocks))


def tile_product_selftest_int8(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The int8 kernel's tile product alone, on the card: ``(64, 256)`` int32
    ``a @ w.T`` for int8 ``a (64, 256)`` and ``w (256, 256)``, through the
    shared-memory ring.  For tests; the port never calls it."""
    if a.shape != (64, 256) or w.shape != (256, 256) or a.dtype != torch.int8 \
            or w.dtype != torch.int8 or a.device.type != "cuda" or w.device != a.device:
        raise ValueError("tile_product_selftest_int8 takes CUDA int8 (64, 256) and (256, 256)")
    lib = _kernel_lib()
    img = tile_image(w.contiguous())
    out = torch.empty((64, 256), dtype=torch.int32, device=a.device)
    a = a.contiguous()
    with torch.cuda.device(a.device):
        err = lib.packed_score_int8_tile_selftest(
            a.data_ptr(), img.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8 tile self-test launch failed ({err}: "
                           f"{lib.packed_score_int8_error_string(err).decode()})")
    return out


def _q8_rows(x: torch.Tensor):
    """Dynamic symmetric per-row int8 of (..., C): integer-valued float32
    codes and (..., 1) float32 scales."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-12) / 127.0
    return torch.round(xf / s), s


def packed_score_int8_reference(
    weights: dict,        # name -> (M, ...): int8 codes, float32 scales, the rest working dtype
    z: torch.Tensor,      # (M, B, N, H) node states, working dtype
    d: torch.Tensor,      # (B, K, N) float32 masked packed distances
    cmask: torch.Tensor,  # (B, K, N) float32 cutoff & encoder mask & 0.5 last slab
    type_r_in: torch.Tensor,   # (B, K, N) int32
    type_p_in: torch.Tensor,
    type_r_out: torch.Tensor,
    type_p_out: torch.Tensor,
    num_blocks: int,
) -> torch.Tensor:
    """Plain PyTorch int8 packed score for M members: (M, B, K, N) float32.

    The int8 products are float32 matrix products of integer-valued tensors.
    That is exact: codes are at most 127 in magnitude, so with 256 terms every
    partial sum stays below 127*127*256 ~ 4.1e6 < 2^24, where float32 holds
    every integer (and so does a TF32 product: its operands keep 11 bits)."""
    packed_score_int8_reference.calls += 1
    dt = z.dtype
    M = z.shape[0]
    B, K, N = d.shape
    w = weights
    S = {k: w["scales"][:, i] for i, k in enumerate(SCALED)}   # each (M,)

    def dot(x, wt):  # x (M, ..., in), wt (M, out, in) -> f32 (M, ..., out)
        flat = x.float().reshape(M, -1, x.shape[-1])
        out = torch.matmul(flat, wt.float().transpose(1, 2))
        return out.reshape(*x.shape[:-1], wt.shape[1])

    def dot8(x, wq, s_w):  # quantize x per row, then acc * (s_row * s_w)
        q, s_row = _q8_rows(x)
        return dot(q, wq) * (s_row * s_w.reshape(M, *[1] * (x.dim() - 1)))

    def row(v, nd):  # (M, F) -> (M, 1, ..., 1, F) broadcasting over nd middle dims
        return v.reshape(v.shape[0], *([1] * nd), v.shape[-1])

    def embed(t):    # a row of the int8 table times the table's scale
        rows = torch.stack([w["table"][m][t.long()] for m in range(M)])   # (M, B, K, N, H)
        return (rows.float() * S["table"].reshape(M, 1, 1, 1, 1)).to(dt)

    h = z
    dv = d.to(dt)[None, ..., None]                 # (1, B, K, N, 1)
    c = cmask.to(dt)[None, ..., None]
    de = _silu(dv * row(w["dw0"], 3) + row(w["db0"], 3))
    de = (dot8(de, w["dw1"], S["dw1"]) + row(w["db1"], 3).float()).to(dt)

    def edge_cat(tr, tp):
        v = (dot8(de * embed(tr), w["c0r"], S["c0r"]) + dot8(de * embed(tp), w["c0p"], S["c0p"])
             + row(w["c0b"], 3).float())
        v = _silu(v.to(dt))
        return (dot8(v, w["c1w"], S["c1w"]) + row(w["c1b"], 3).float()).to(dt)

    ea = edge_cat(type_r_in, type_p_in)
    ea_q, ea_s = _q8_rows(ea)                      # feeds every block: quantized once
    for l in range(num_blocks):
        s1 = ea_s * w["f1w_s"][:, l].reshape(M, 1, 1, 1, 1)
        f = ssp((dot(ea_q, w["f1w"][:, l]) * s1 + row(w["f1b"][:, l], 3).float()).to(dt))
        f = (dot8(f, w["f2w"][:, l], w["f2w_s"][:, l]) + row(w["f2b"][:, l], 3).float()).to(dt) * c
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
    g = (dot8(hh, w["g0h"], S["g0h"]) + dot8(ea_out, w["g0e"], S["g0e"])
         + row(w["g0b"], 3).float())
    g = _silu(g.to(dt))
    g = _silu((dot8(g, w["g1w"], S["g1w"]) + row(w["g1b"], 3).float()).to(dt))
    out = (g.float() * row(w["g2w"], 3).float()).sum(-1) + w["g2b"].float().reshape(M, 1, 1, 1)
    return out


packed_score_int8_reference.calls = 0


def packed_score_int8_cost(weights: dict, z: torch.Tensor, num_blocks: int) -> dict:
    """Work of one call, for its bound, counted as ``packed_score_cost``
    does: ``int8_ops`` are the pair-row products (int8 on the tensor cores),
    ``flops`` the node products and the head's last layer (working type), and
    ``bytes`` every input read once and the output written once.  The bound
    on operations is the sum of the two kinds' times."""
    M, B, N, H = z.shape
    R, L = (N // 2) * N, num_blocks
    total = packed_score_cost(weights, z, num_blocks)
    node = 2 * M * B * L * N * 3 * H * H
    last = 2 * M * B * R * (H // 2)
    return {"int8_ops": total["flops"] - node, "flops": node + last, "bytes": total["bytes"]}


def _check_cuda_args(weights, z, d, cmask, types, num_blocks):
    if z.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"z must be float32 or bfloat16, got {z.dtype}")
    if z.dim() != 4 or not z.is_contiguous():
        raise ValueError("z must be a contiguous (M, B, N, H) tensor")
    M, B, N, H = z.shape
    K = N // 2
    if N % 8 or H % 64:
        raise ValueError(f"the CUDA kernel needs N % 8 == 0 and H % 64 == 0, got N={N}, H={H}")
    L, V = num_blocks, weights["table"].shape[1]
    want = [("d", d, torch.float32, (B, K, N)), ("cmask", cmask, torch.float32, (B, K, N))]
    want += [(f"types[{i}]", t, torch.int32, (B, K, N)) for i, t in enumerate(types)]
    shapes = dict(
        table=(V, H), dw0=(H,), db0=(H,), dw1=(H, H), db1=(H,), c0r=(H, H), c0p=(H, H),
        c0b=(H,), c1w=(H, H), c1b=(H,), f1w=(L, H, H), f1b=(L, H), f2w=(L, H, H),
        f2b=(L, H), l1w=(L, H, H), l2w=(L, H, H), l2b=(L, H), ow=(L, H, H), ob=(L, H),
        g0h=(H, H), g0e=(H, H), g0b=(H,), g1w=(H // 2, H), g1b=(H // 2,), g2w=(H // 2,),
        g2b=(1,), scales=(len(SCALED),), f1w_s=(L,), f2w_s=(L,),
    )
    for k in (*SCALE_KEYS, *W_ORDER):
        dtype = torch.int8 if k in QUANTIZED else torch.float32 if k in SCALE_KEYS else z.dtype
        want.append((f"weight {k}", weights[k], dtype, (M, *shapes[k])))
    for name, t, dtype, shape in want:
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous() \
                or t.device != z.device:
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} tensor on "
                             f"{z.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return M, B, N, H, L, V


def _check_images(weights, M, L, H, z) -> tuple[torch.Tensor, torch.Tensor]:
    want = ((WG_IMAGE8, torch.int8, (13 + 4 * L) * (H * H // 2)), (WG_IMAGE, z.dtype, 3 * L * H * H))
    for key, dtype, n in want:
        t = weights.get(key)
        if t is None:
            raise ValueError(f"this shape takes the warp-specialised kernel, which needs the "
                             f"arranged weights[{key!r}] (with_wg_images_int8)")
        if tuple(t.shape) != (M, n) or t.dtype != dtype or not t.is_contiguous() \
                or t.device != z.device:
            raise ValueError(f"weights[{key!r}] must be a contiguous {dtype} {(M, n)} tensor on "
                             f"{z.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return weights[WG_IMAGE8], weights[WG_IMAGE]


def packed_score_int8(
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
    """Packed ``edge_inv`` (M, B, K, N) float32 for M members with int8
    pair-row products.  CPU tensors take ``packed_score_int8_reference``; CUDA
    tensors launch a kernel on the current stream, or raise.

    Which kernel is decided by the shape alone, in ``packed_score_int8_launch``:
    bfloat16 at H = 256 with N <= 24 takes the warp-specialised ``wgmma``
    kernel, which needs the arranged entries ``weights[WG_IMAGE8]`` and
    ``weights[WG_IMAGE]`` (``with_wg_images_int8``) and raises without them;
    float32, other widths and larger N take the ``mma.sync`` kernel.  Neither
    gives way to the other, or to the plain version, when it fails.
    ``.launches`` counts all launches, ``.wg_launches`` the warp-specialised."""
    types = (type_r_in, type_p_in, type_r_out, type_p_out)
    if z.device.type == "cpu":
        return packed_score_int8_reference(weights, z, d, cmask, *types, num_blocks)
    if z.device.type != "cuda":
        raise ValueError(f"packed_score_int8 runs on CPU or CUDA tensors, got {z.device}")
    M, B, N, H, L, V = _check_cuda_args(weights, z, d, cmask, types, num_blocks)
    lib = _kernel_lib()
    R = (N // 2) * N
    use_wg = bool(lib.packed_score_int8_uses_wg(N, H, int(z.dtype == torch.bfloat16)))
    out = torch.empty((M, B, N // 2, N), dtype=torch.float32, device=z.device)
    if use_wg:
        images = _check_images(weights, M, L, H, z)
        R = -(-R // TILE_ROWS) * TILE_ROWS       # the kernel's own scratch: 64-row tiles
    else:
        images = (None, None)
    ea_q = torch.empty((M * B, R, H), dtype=torch.int8, device=z.device)
    ea_s = torch.empty((M * B, R), dtype=torch.float32, device=z.device)
    tensors = [d, cmask, z, *types, *(weights[k] for k in SCALE_KEYS),
               *(weights[k] for k in W_ORDER), *images, ea_q, ea_s, out]
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])
    stream = torch.cuda.current_stream(z.device).cuda_stream
    with torch.cuda.device(z.device):
        err = lib.packed_score_int8_launch(
            ptrs, M, B, N, H, L, V, int(z.dtype == torch.bfloat16), stream
        )
    if err != 0:
        msg = lib.packed_score_int8_error_string(err).decode()
        raise RuntimeError(
            f"packed_score_int8 kernel launch failed ({err}: {msg}) at M={M} B={B} N={N} "
            f"H={H} dtype={z.dtype}"
        )
    packed_score_int8.launches += 1
    packed_score_int8.wg_launches += int(use_wg)
    return out


packed_score_int8.launches = 0
packed_score_int8.wg_launches = 0
