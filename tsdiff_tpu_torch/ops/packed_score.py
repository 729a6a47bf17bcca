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
  first use) or raises.  ``packed_score.launches`` counts kernel launches,
  ``packed_score.wg_launches`` those of the warp-specialised kernel, and
  ``packed_score_reference.calls`` counts plain-version calls.

What bounds the kernel on an H100 at the main path's shapes (M=8 members,
B=100 graphs, N=24, H=F=256, L=7, bf16): the work counted as in
``condensed_score_packed.py:222-228`` minus its one-hot term (4*128*H per
row, a row read here) is ~7.6e11 flop per launch against ~56 MB of inputs
and outputs (mostly the members' weights), so the tensor-core rate bounds
it: ~0.77 ms at 989 TFLOP/s, against ~17 us for the bytes at 3.35 TB/s.

Two kernels live in ``csrc/packed_score.cu``.  bfloat16 at H = 256 and
N <= 24 takes the warp-specialised one (``csrc/wg_pipeline.cuh``): a
producer warp streams weight stages through a shared-memory ring with bulk
asynchronous copies, two consumer warpgroups run ``wgmma`` on one 64-row tile
each, so a stage read from L2 serves 128 pair rows (``wg_l2_weight_bytes``
against ``mma_sync_l2_weight_bytes``).  It reads the matrices from
``weights[WG_IMAGE]``, the copy ``arrange_weights`` makes once, in exactly the
swizzled image ``wgmma`` reads, and f2w from ``weights[WG_IMAGE_F2K]``, its
K-blocks (``kblock_image``) for the filter chain, which keeps f1's output in
registers as f2's A operand (``with_wg_images`` adds both).  float32, other
widths and larger N take the first port's ``mma.sync`` kernel, by the explicit
branch in ``packed_score_launch``.  See the source's header for the design and
what the card said about it.
"""

from __future__ import annotations

import ctypes

import torch

from tsdiff_tpu_torch.ops.condensed_score import W_ORDER as _DENSE_ORDER
from tsdiff_tpu_torch.ops.condensed_score import (  # the names shared with the dense kernel
    STAGE_BYTES,
    STAGE_COLS,
    TILE_ROWS,
    WG_IMAGE,
    extract_weights,
    stage_schedule,
    with_wg_image,
)
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
    lib.packed_score_uses_wg.argtypes = [ctypes.c_int] * 3
    lib.packed_score_uses_wg.restype = ctypes.c_int
    lib.packed_score_tile_selftest.argtypes = [ctypes.c_void_p] * 5
    lib.packed_score_tile_selftest.restype = ctypes.c_int
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


# ---------------------------------------------------------------------------
# The warp-specialised kernel's weight image and static schedule.

#: matrices of the image, in the order ``csrc/packed_score.cu::WImage`` reads
#: them; the layer-stacked ones hold their L layers one after another
IMAGE_ORDER = ("dw1", "c0r", "c0p", "c1w", "f1w", "f2w", "l1w", "l2w", "ow", "g0h", "g0e", "g1w")


def _swizzle_index(block_rows: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    rows = torch.arange(block_rows, device=device)[:, None]
    return rows, torch.arange(8, device=device)[None, :] ^ (rows % 8)


def tile_image(w: torch.Tensor, block_rows: int = STAGE_COLS) -> torch.Tensor:
    """``w (..., rows, K)`` in the image ``wgmma`` reads from shared memory,
    flattened to ``(..., rows * K)``: blocks of ``block_rows`` rows (a weight
    stage's 32, or an activation tile's 64), each block its atoms one after
    another, an atom being ``block_rows`` rows of 128 bytes (K elements
    ``[kc*A, (kc+1)*A)``, ``A = 128 / itemsize``) in which the 16-byte unit
    ``u`` of row ``r`` sits at unit ``u ^ (r % 8)``: the 128-byte swizzle."""
    atom, unit = 128 // w.element_size(), 16 // w.element_size()
    *lead, rows, K = w.shape
    if rows % block_rows or block_rows % 8 or K % atom:
        raise ValueError(f"tile_image needs rows % {block_rows} == 0 and K % {atom} == 0, "
                         f"got {rows}, {K}")
    x = w.reshape(*lead, rows // block_rows, block_rows, K // atom, 8, unit)
    x = x.movedim(-3, -4)                       # (..., block, atom, row, unit index, element)
    r, u = _swizzle_index(block_rows, w.device)
    return x[..., r, u, :].reshape(*lead, rows * K).contiguous()


def tile_image_inverse(img: torch.Tensor, rows: int, K: int,
                       block_rows: int = STAGE_COLS) -> torch.Tensor:
    """``(..., rows, K)`` back from ``tile_image``'s ``(..., rows * K)``."""
    atom, unit = 128 // img.element_size(), 16 // img.element_size()
    lead = img.shape[:-1]
    x = img.reshape(*lead, rows // block_rows, K // atom, block_rows, 8, unit)
    r, u = _swizzle_index(block_rows, img.device)
    x = x[..., r, u, :]                         # the XOR is its own inverse
    return x.movedim(-4, -3).reshape(*lead, rows, K).contiguous()


def arrange_weights(weights: dict) -> torch.Tensor:
    """The matrices of ``IMAGE_ORDER`` as one flat tensor of tile images, in
    the weights' type: what the kernel's producer copies, 16 KB a stage, into
    its shared-memory ring.  Works on one member's weights or on stacked
    ``(M, ...)`` ones (the leading dimensions of ``dw1`` stay).  Made once, when
    the weight dictionary is built; the plain version never reads it."""
    lead = weights["dw1"].dim() - 2
    return torch.cat([tile_image(weights[k]).flatten(lead) for k in IMAGE_ORDER], dim=-1)


#: B1's own arranged entry: f2w of every layer as K-blocks (``kblock_image``)
WG_IMAGE_F2K = "wg_image_f2k"


def _kblock_swizzle(rows: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    r = torch.arange(rows, device=device)[:, None]
    return r, torch.arange(4, device=device)[None, :] ^ ((r >> 1) % 4)


def kblock_image(w: torch.Tensor) -> torch.Tensor:
    """``w (..., rows, K)`` bfloat16 as the K-block image the filter chain's
    full-width product reads, flattened to ``(..., rows * K)``: K-blocks of 32
    columns one after another, each its ``rows`` rows of 64 bytes one after
    another, in which the 16-byte unit ``u`` of row ``r`` sits at unit
    ``u ^ ((r >> 1) % 4)``: the 64-byte swizzle.  A K-block of f2w (256 rows)
    is one 16 KB ring stage."""
    *lead, rows, K = w.shape
    if w.element_size() != 2 or rows % 8 or K % 32:
        raise ValueError(f"kblock_image needs a 16-bit (rows, K) with rows % 8 == 0 and "
                         f"K % 32 == 0, got {w.dtype} {rows}, {K}")
    x = w.reshape(*lead, rows, K // 32, 4, 8).movedim(-3, -4)  # (..., block, row, unit, element)
    r, u = _kblock_swizzle(rows, w.device)
    return x[..., r, u, :].reshape(*lead, rows * K).contiguous()


def kblock_image_inverse(img: torch.Tensor, rows: int, K: int) -> torch.Tensor:
    """``(..., rows, K)`` back from ``kblock_image``'s ``(..., rows * K)``."""
    lead = img.shape[:-1]
    x = img.reshape(*lead, K // 32, rows, 4, 8)
    r, u = _kblock_swizzle(rows, img.device)
    return x[..., r, u, :].movedim(-4, -3).reshape(*lead, rows, K).contiguous()


def arrange_f2_kblocks(f2w: torch.Tensor) -> torch.Tensor:
    """f2w ``(..., L, H, H)`` as the flat K-block images of its L layers, one
    after another: B1's ``WG_IMAGE_F2K``."""
    return kblock_image(f2w).flatten(-2)


def with_wg_images(weights: dict) -> dict[str, torch.Tensor]:
    """``weights`` with B1's arranged entries: ``WG_IMAGE`` (the image B2 and
    B5 read too) and ``WG_IMAGE_F2K``.  Made once, where the weight dictionary
    is built (``CondenseEncoderEpsNetwork.kernel_weights``); the plain version never
    reads them."""
    return {**with_wg_image(weights), WG_IMAGE_F2K: arrange_f2_kblocks(weights["f2w"])}


def split_image(image: torch.Tensor, num_blocks: int, H: int = 256) -> dict[str, torch.Tensor]:
    """The matrices back from ``arrange_weights``'s tensor: its inverse."""
    out, pos, L = {}, 0, num_blocks
    for k in IMAGE_ORDER:
        shape = (H // 2, H) if k == "g1w" else (L, H, H) if k in ("f1w", "f2w", "l1w", "l2w", "ow") \
            else (H, H)
        n = int(torch.tensor(shape).prod())
        flat = image[..., pos:pos + n].reshape(*image.shape[:-1], *shape[:-2], shape[-2] * shape[-1])
        out[k] = tile_image_inverse(flat, shape[-2], shape[-1])
        pos += n
    return out


def packed_row_pairs(N: int) -> torch.Tensor:
    """``(R, 2)`` int64: the atoms ``(i, j)`` of every packed pair row
    ``p = (k-1)*N + i``, ``j = (i + k) % N``, as the kernel tabulates them once
    per CTA (no division per row afterwards)."""
    p = torch.arange((N // 2) * N)
    k, i = p // N + 1, p % N
    return torch.stack([i, torch.where(i + k < N, i + k, i + k - N)], dim=1)


def aggregate_by_node(w: torch.Tensor, xh: torch.Tensor) -> torch.Tensor:
    """The kernel's symmetric aggregation, stated per receiving node:
    ``agg[n] = sum_k rnd(w[k, n] * xh[(n+k) % N]) + rnd(w[k, n-k] * xh[(n-k) % N])``
    for ``w (K, N, F)`` and ``xh (N, F)`` in the working type, products rounded
    to it, summed in float32.  Equal to the plain version's roll sums up to
    the order of the float32 additions."""
    K, N, _ = w.shape
    n = torch.arange(N)
    agg = torch.zeros(xh.shape, dtype=torch.float32)
    for k in range(1, K + 1):
        agg = agg + (w[k - 1] * xh[(n + k) % N]).float()
        agg = agg + (w[k - 1][(n - k) % N] * xh[(n - k) % N]).float()
    return agg


def wg_tile_pairs(N: int) -> int:
    """Tile pairs of one graph's R = (N/2)*N packed pair rows: a stage feeds
    two 64-row tiles, one per consumer warpgroup."""
    return (-(-((N // 2) * N) // TILE_ROWS) + 1) // 2


def wg_schedule(N: int, num_blocks: int) -> list[tuple[str, int, int]]:
    """The static schedule of weight stages every CTA of the warp-specialised
    kernel walks, producer and consumers alike: ``(matrix, layer, block)``
    per stage, over ``wg_tile_pairs(N)`` tile pairs; the node products run
    through the same ring.  It is ``ops.condensed_score.stage_schedule`` with
    each tile pair's filter chain reordered: f2w's stages are its 32-column
    K-blocks (from ``WG_IMAGE_F2K``), taken as f1w(0), then f1w(c+1) and
    f2w's K-block c in turn, then f2w's K-block 7 (``csrc/packed_score.cu::
    filter_chain``).  The same stages, so the same L2 bytes."""
    sched, out, i = stage_schedule(wg_tile_pairs(N), num_blocks), [], 0
    blocks = 256 // STAGE_COLS
    while i < len(sched):
        name, l, _ = sched[i]
        if name != "f1w":
            out.append(sched[i])
            i += 1
            continue
        out.append(("f1w", l, 0))
        for c in range(blocks):
            out += [("f1w", l, c + 1)] if c + 1 < blocks else []
            out.append(("f2w", l, c))
        i += 2 * blocks
    return out


def wg_l2_weight_bytes(M: int, B: int, N: int, num_blocks: int) -> int:
    """Weight bytes one launch of the warp-specialised kernel reads from L2:
    one 16 KB stage per schedule entry and CTA."""
    return M * B * len(wg_schedule(N, num_blocks)) * STAGE_BYTES


def mma_sync_l2_weight_bytes(M: int, B: int, N: int, num_blocks: int, H: int = 256,
                             itemsize: int = 2) -> int:
    """The same for the ``mma.sync`` kernel, which reads every matrix once
    per 64-row tile: per tile 8 matrices of ``edge_cat`` (twice: encoder and
    output order), 2 per block and the head's 2.5, and 3 node products per
    block."""
    tiles = -(-((N // 2) * N) // TILE_ROWS)
    per_cta = tiles * (8 + 2 * num_blocks + 2.5) + 3 * num_blocks
    return int(M * B * per_cta * H * H * itemsize)


def tile_product_selftest(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's tile product alone, on the card: ``(3, 64, 256)`` float32
    ``a @ w.T`` for ``a (64, 256)`` and ``w (256, 256)`` in bfloat16, through
    the shared-memory ring with ``a`` from shared memory (index 0) and from
    registers (index 1), and full width from ``w``'s K-blocks with ``a`` from
    registers (index 2, as the filter chain runs f2).  For tests; the port
    never calls it."""
    if a.shape != (64, 256) or w.shape != (256, 256) or a.dtype != torch.bfloat16 \
            or w.dtype != torch.bfloat16 or a.device.type != "cuda" or w.device != a.device:
        raise ValueError("tile_product_selftest takes CUDA bfloat16 (64, 256) and (256, 256)")
    lib = _kernel_lib()
    img, kimg = tile_image(w.contiguous()), kblock_image(w.contiguous())
    out = torch.empty((3, 64, 256), dtype=torch.float32, device=a.device)
    a = a.contiguous()
    with torch.cuda.device(a.device):
        err = lib.packed_score_tile_selftest(
            a.data_ptr(), img.data_ptr(), kimg.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tile self-test launch failed ({err}: "
                           f"{lib.packed_score_error_string(err).decode()})")
    return out


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
    term) and the bytes of its inputs read once and its output written once
    (the arranged copies of the matrices, the ``wg_image*`` entries, are not a
    second input: they are left out)."""
    M, B, N, H = z.shape
    R, F, L = (N // 2) * N, H, num_blocks
    flops = 2 * M * B * R * (
        H * H + 2 * 3 * H * H + L * (H * F + F * F) + 2 * H * H + H * (H // 2)
    ) + 2 * M * B * L * N * (H * F + F * H + H * H)
    nbytes = (
        6 * B * R * 4                       # d, cmask, 4 type tensors
        + z.numel() * z.element_size()
        + sum(t.numel() * t.element_size() for k, t in weights.items()
              if not k.startswith(WG_IMAGE))
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


def _check_images(weights, M, L, H, z) -> tuple[torch.Tensor, torch.Tensor]:
    images = []
    for key, n in ((WG_IMAGE, (13 + 10 * L) * (H * H // 2)), (WG_IMAGE_F2K, L * H * H)):
        image = weights.get(key)
        if image is None:
            raise ValueError(f"this shape takes the warp-specialised kernel, which needs the "
                             f"arranged weights[{key!r}] (with_wg_images)")
        if tuple(image.shape) != (M, n) or image.dtype != z.dtype or not image.is_contiguous() \
                or image.device != z.device:
            raise ValueError(f"weights[{key!r}] must be a contiguous {z.dtype} {(M, n)} tensor "
                             f"on {z.device}, got {image.dtype} {tuple(image.shape)} on "
                             f"{image.device}")
        images.append(image)
    return images[0], images[1]


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
    take ``packed_score_reference``; CUDA tensors launch a kernel on the
    current stream, or raise.

    Which kernel is decided by the shape alone, in ``packed_score_launch``:
    bfloat16 at H = 256 with N <= 24 (what its shared memory holds) takes the
    warp-specialised ``wgmma`` kernel, which needs the arranged entries
    ``weights[WG_IMAGE]`` and ``weights[WG_IMAGE_F2K]`` (``with_wg_images``)
    and raises without them; float32,
    other widths and larger N take the ``mma.sync`` kernel.  Neither gives
    way to the other, or to the plain version, when it fails.
    ``packed_score.launches`` counts all launches, ``packed_score.wg_launches``
    those of the warp-specialised kernel."""
    types = (type_r_in, type_p_in, type_r_out, type_p_out)
    if z.device.type == "cpu":
        return packed_score_reference(weights, z, d, cmask, *types, num_blocks)
    if z.device.type != "cuda":
        raise ValueError(f"packed_score runs on CPU or CUDA tensors, got {z.device}")
    M, B, N, H, L, V = _check_cuda_args(weights, z, d, cmask, types, num_blocks)
    lib = _kernel_lib()
    K = N // 2
    use_wg = bool(lib.packed_score_uses_wg(N, H, int(z.dtype == torch.bfloat16)))
    out = torch.empty((M, B, K, N), dtype=torch.float32, device=z.device)
    if use_wg:
        image, f2k = _check_images(weights, M, L, H, z)
        # the kernel's own scratch: ea as 64-row tile images
        ea = torch.empty((M * B, -(-(K * N) // TILE_ROWS), TILE_ROWS * H), dtype=z.dtype,
                         device=z.device)
    else:
        image = f2k = None
        ea = torch.empty((M * B, K * N, H), dtype=z.dtype, device=z.device)
    tensors = [d, cmask, z, *types, *(weights[k] for k in W_ORDER), image, f2k, ea, out]
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])
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
    packed_score.wg_launches += int(use_wg)
    return out


packed_score.launches = 0
packed_score.wg_launches = 0
