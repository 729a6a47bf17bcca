"""Fused SchNet interaction stack: CUDA kernels, plain twins and autograd.

Replaces the TPU kernels ``tsdiff_tpu/ops/pallas/schnet_stack_vjp.py::
interaction_stack_pallas_trainable`` (forward ``_fwd_kernel``, backward
``_bwd_kernel``) and ``tsdiff_tpu/ops/pallas/schnet_stack.py::
interaction_stack_pallas`` (``_stack_kernel``, the forward without the saved
block inputs).  Per block l, on the pair rows p = i*N + j of each graph:

    w   = rnd(rnd(ssp(rnd(ea f1w + f1b)) f2w + f2b) * c)
    xh  = rnd(h l1w);   agg[j] = rnd(sum_i rnd(w[i*N+j] * xh[i]))
    h  += rnd(ssp(rnd(agg l2w + l2b)) ow + ob)

rnd() rounds to the working type; products accumulate in float32.  The
backward recomputes each block's pair filter in reverse (ssp' = sigmoid) and
returns dh, dea and the nine weight gradients summed over graphs, all
float32, with the TPU kernel's casts of dagg, da2, ds1 and da1.

* ``schnet_stack_fwd_reference`` / ``schnet_stack_bwd_reference`` /
  ``interaction_stack_reference``: the plain PyTorch versions, at the TPU
  kernel's rounding points.  The backward is an explicit port of
  ``_bwd_kernel``, not autograd.
* ``schnet_stack_fwd`` / ``schnet_stack_bwd`` / ``interaction_stack_pallas``:
  the wrappers.  CPU tensors take the plain version; CUDA tensors launch
  ``csrc/schnet_stack.cu`` (built at first use) or raise.  Each wrapper's
  ``launches`` counts its kernel launches (one per call; the backward's call
  runs 4 kernels per block) and each plain version's ``calls`` its calls.
* ``schnet_stack_xty`` / ``xty_reference``: one block of the backward's
  weight-gradient products alone (``_bwd_kernel``'s ``dot(X.T, Y)``), the
  kernel the backward runs for them and its plain version.
* ``InteractionStackFn``: the autograd function of the training path
  (``interaction_stack_pallas_trainable``).

Layouts at these functions are the JAX package's: weights ``(L, in, out)``
and biases ``(L, out)``; ``ea (B, P, E)``, ``c (B, P)`` and ``h (B, N, H)``
in the working type, ``P = N*N``.

What bounds the kernels on an H100 at the training shapes (B=200, N=24,
H=F=E=256, L=7, bf16): the forward is 2.25e11 flop of matrix products
(the TPU kernel's own estimate, ``schnet_stack.py:129``), 0.23 ms at 989
TFLOP/s, against 59 MB of ``ea``; the backward is 6.7e11 flop, 0.68 ms,
against ~180 MB.  Both are bound by the tensor cores (``schnet_stack_cost``).
The design (one CTA per graph, pair tiles streamed from L2, a deterministic
split-K reduction for the weight gradients) is described in the source.

The forward and the backward's per-graph row kernel each have two versions,
chosen by the shape alone in the library (``schnet_stack_fwd_uses_wg``,
``schnet_stack_bwd_uses_wg``): bfloat16 at H = 256 with N <= 24 takes the
``wgmma`` kernel on ``csrc/wg_pipeline.cuh`` (each wrapper's ``wg_launches``
counts those calls), everything else the first port's ``mma.sync`` kernel.
Both ``wgmma`` kernels read one image of every block's ten weight matrices
(``arrange_stack_weights``) and ``ea`` as 64-row tile images
(``ea_tile_images``); ``InteractionStackFn`` makes both once per train step,
in its forward, and hands them to its backward.  Their host side is here for
the tests: the image, the static schedules of weight stages
(``stack_fwd_schedule``, ``stack_bwd_schedule``) and the order of the row
kernel's pass-2 sum (``dxh_by_source``).

The backward's weight gradients have two versions too, chosen by the shape
alone (``schnet_stack_bwd_xty_uses_wg``): bfloat16 at H = 256 takes the
``wgmma`` weight-gradient kernel (``.xty_wg_launches`` on the backward),
which reads the row kernel's row-major scratch by 2-D tensor copies and
deals its work in equal ranges to one CTA per SM (``xty_schedule``, made here
once per shape and device); everything else the first port's ``mma.sync``
split-K kernel (``PAIR_ROWS_PER_SPLIT``, ``NODE_ROWS_PER_SPLIT``).
"""

from __future__ import annotations

import ctypes
import math

import torch

#: the stack's weights, in the order the kernels and the gradients take them
W_KEYS = ("f1w", "f1b", "f2w", "f2b", "l1w", "l2w", "l2b", "ow", "ob")
_MATS = ("f1w", "f2w", "l1w", "l2w", "ow")
_LIB = "schnet_stack"
_LOG2 = 0.6931471805599453
#: rows per split of the ``mma.sync`` weight-gradient kernel (pair rows, node rows)
PAIR_ROWS_PER_SPLIT = 2048
NODE_ROWS_PER_SPLIT = 512
#: the ``wgmma`` weight-gradient kernel (``csrc/schnet_stack.cu::
#: schnet_bwd_xty_wg_kernel``): outputs of XTY_TILE_M rows of a gradient,
#: reductions in stages of XTY_STAGE_ROWS rows, and the MN-major operand
#: layout of ``csrc/wg_pipeline.cuh`` (``kMnBoxBytes``, ``kMnGroupBytes``,
#: ``kMnK16Bytes``): boxes of 64 columns by 64 rows with the 128-byte swizzle,
#: 8-row groups along K, and a k16 step 16 rows on
XTY_TILE_M = 128
XTY_STAGE_ROWS = 64
XTY_BOX_BYTES = 8192
XTY_GROUP_BYTES = 1024
XTY_K16_BYTES = 2048
#: the weight-gradient products per block, pair-row jobs first:
#: ``(gradient, X, Y)`` in the kernels' job order
XTY_JOBS = (("f1w", "ea", "da1"), ("f2w", "s1", "da2"), ("l1w", "hl", "dxh"),
            ("l2w", "agg", "da3"), ("ow", "s3", "gd"))
#: the ten matrices of a block in the ``wgmma`` kernels' image
#: (``csrc/schnet_stack.cu::StackMat``): the row kernel's producer walks the
#: first nine in this order, the forward's reads the five "_t" ones.  "_t"
#: marks a matrix transposed to (out, in), the B operand of a forward product
#: X W; the others stay (in, out), the B operand of a backward product Y W^T
STACK_ORDER = ("l1w_t", "f1w_t", "f2w_t", "l2w_t", "ow", "l2w", "f2w", "f1w", "l1w", "ow_t")


def _kernel_lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures declared."""
    from tsdiff_tpu_torch.ops import _build

    lib = _build.load(_LIB)
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    lib.schnet_stack_fwd_launch.argtypes = [ptrs, *[ctypes.c_int] * 6, ctypes.c_void_p]
    lib.schnet_stack_fwd_launch.restype = ctypes.c_int
    lib.schnet_stack_bwd_launch.argtypes = [ptrs, *[ctypes.c_int] * 8, ctypes.c_void_p]
    lib.schnet_stack_bwd_launch.restype = ctypes.c_int
    lib.schnet_stack_xty_launch.argtypes = [ptrs, *[ctypes.c_int] * 7, ctypes.c_void_p]
    lib.schnet_stack_xty_launch.restype = ctypes.c_int
    for fn in (lib.schnet_stack_fwd_uses_wg, lib.schnet_stack_bwd_uses_wg):
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_int
    lib.schnet_stack_bwd_xty_uses_wg.argtypes = [ctypes.c_int] * 4
    lib.schnet_stack_bwd_xty_uses_wg.restype = ctypes.c_int
    lib.schnet_stack_error_string.argtypes = [ctypes.c_int]
    lib.schnet_stack_error_string.restype = ctypes.c_char_p
    return lib


# ---------------------------------------------------------------------------
# Plain versions


def ssp(x: torch.Tensor) -> torch.Tensor:
    """Shifted softplus evaluated in float32, rounded to x's type."""
    xf = x.float()
    return (torch.clamp(xf, min=0.0) + torch.log1p(torch.exp(-xf.abs())) - _LOG2).to(x.dtype)


def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (..., in) @ w (in, out) with float32 accumulation."""
    return torch.matmul(a.float(), w.float())


def _xty(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sum over all rows of all graphs of x^T y, float32: (in, out)."""
    return _dot(x.reshape(-1, x.shape[-1]).t(), y.reshape(-1, y.shape[-1]))


def _block_filter(w: dict, l: int, ea: torch.Tensor, c: torch.Tensor):
    """Block l's pair filter: (a1 f32, s1, w) with w = rnd(rnd(a2) * c)."""
    dt = ea.dtype
    a1 = _dot(ea, w["f1w"][l]) + w["f1b"][l].float()
    s1 = ssp(a1.to(dt))
    a2 = _dot(s1, w["f2w"][l]) + w["f2b"][l].float()
    return a1, s1, a2.to(dt) * c[..., None]


def _aggregate(wv: torch.Tensor, xh: torch.Tensor) -> torch.Tensor:
    """agg[j] = rnd(sum_i rnd(w[i*N+j] * xh[i])): (B, N, F)."""
    B, N, F = xh.shape
    w3 = wv.reshape(B, N, N, F)
    return (w3 * xh[:, :, None, :]).float().sum(1).to(xh.dtype)


def forward_plain(w: dict, h: torch.Tensor, ea: torch.Tensor, c: torch.Tensor, store_hs: bool):
    """The stack's plain forward, ``(out, hs or None)``; the dense score's
    plain version (``ops.condensed_score``) runs its blocks through it too."""
    dt = h.dtype
    L = w["f1w"].shape[0]
    hs = []
    for l in range(L):
        if store_hs:
            hs.append(h)
        _, _, wv = _block_filter(w, l, ea, c)
        xh = _dot(h, w["l1w"][l]).to(dt)
        agg = _aggregate(wv, xh)
        conv = (_dot(agg, w["l2w"][l]) + w["l2b"][l].float()).to(dt)
        h = h + (_dot(ssp(conv), w["ow"][l]) + w["ob"][l].float()).to(dt)
    return h, (torch.stack(hs, dim=1) if store_hs else None)


def schnet_stack_fwd_reference(w: dict, h: torch.Tensor, ea: torch.Tensor, c: torch.Tensor):
    """Plain forward: ``(out (B, N, H), hs (B, L, N, H))`` in h's type, ``hs``
    holding each block's input."""
    schnet_stack_fwd_reference.calls += 1
    return forward_plain(w, h, ea, c, store_hs=True)


def interaction_stack_reference(w: dict, h: torch.Tensor, ea: torch.Tensor, c: torch.Tensor):
    """Plain forward without the saved block inputs: ``out (B, N, H)``."""
    interaction_stack_reference.calls += 1
    return forward_plain(w, h, ea, c, store_hs=False)[0]


def schnet_stack_bwd_reference(w: dict, ea: torch.Tensor, c: torch.Tensor, hs: torch.Tensor,
                               g: torch.Tensor, operands: list | None = None):
    """Plain backward, an explicit port of ``_bwd_kernel``: ``(dh (B, N, H),
    dea (B, P, E), grads)``, all float32, ``grads`` keyed by ``W_KEYS`` in
    the weights' shapes and summed over graphs.  Given a list as
    ``operands``, appends per block, from the last to the first, the
    weight-gradient products' operands ``(xs, ys)`` in ``XTY_JOBS`` order, as
    contiguous ``(rows, H)`` tensors in the working type."""
    schnet_stack_bwd_reference.calls += 1
    dt = ea.dtype
    B, L, N, H = hs.shape
    F = w["f1w"].shape[-1]
    g = g.float()
    dea = torch.zeros(ea.shape, dtype=torch.float32, device=ea.device)
    grads = {k: torch.zeros(w[k].shape, dtype=torch.float32, device=ea.device) for k in W_KEYS}
    cc = c[..., None]
    for l in reversed(range(L)):
        h_l = hs[:, l]
        a1, s1, wv = _block_filter(w, l, ea, c)
        xh = _dot(h_l, w["l1w"][l]).to(dt)
        agg = _aggregate(wv, xh)
        a3 = _dot(agg, w["l2w"][l]) + w["l2b"][l].float()
        s3 = ssp(a3.to(dt))

        gd = g.to(dt)
        grads["ow"][l] = _xty(s3, gd)
        grads["ob"][l] = g.sum((0, 1))
        da3 = _dot(gd, w["ow"][l].t()) * torch.sigmoid(a3)
        grads["l2w"][l] = _xty(agg, da3.to(dt))
        grads["l2b"][l] = da3.sum((0, 1))
        dagg = _dot(da3.to(dt), w["l2w"][l].t()).to(dt)             # (B, N, F)

        w3 = wv.reshape(B, N, N, F)
        dw3 = xh[:, :, None, :] * dagg[:, None, :, :]               # [i, j] = xh[i] dagg[j]
        dxh = (w3 * dagg[:, None, :, :]).float().sum(2).to(dt)      # sum over targets j
        grads["l1w"][l] = _xty(h_l, dxh)
        dh_from_xh = _dot(dxh, w["l1w"][l].t())

        da2 = dw3.reshape(B, N * N, F) * cc
        grads["f2w"][l] = _xty(s1, da2)
        grads["f2b"][l] = da2.float().sum((0, 1))
        ds1 = _dot(da2, w["f2w"][l].t()).to(dt)
        da1 = ds1 * torch.sigmoid(a1).to(dt)
        grads["f1w"][l] = _xty(ea, da1)
        grads["f1b"][l] = da1.float().sum((0, 1))
        dea = dea + _dot(da1, w["f1w"][l].t())
        g = g + dh_from_xh
        if operands is not None:
            rows = [t.reshape(-1, t.shape[-1]).contiguous() for t in
                    (ea, s1, h_l, agg, s3, da1, da2, dxh, da3.to(dt), gd)]
            operands.append((rows[:5], rows[5:]))
    return g, dea, grads


def xty_reference(xs: list, ys: list) -> torch.Tensor:
    """Plain version of one block's weight-gradient products: ``(5, H, H)``
    float32, ``xs[k]^T ys[k]`` in ``XTY_JOBS`` order."""
    xty_reference.calls += 1
    return torch.stack([_xty(x, y) for x, y in zip(xs, ys)])


schnet_stack_fwd_reference.calls = 0
schnet_stack_bwd_reference.calls = 0
interaction_stack_reference.calls = 0
xty_reference.calls = 0


# ---------------------------------------------------------------------------
# The wgmma kernels' host side


def arrange_stack_weights(w: dict) -> torch.Tensor:
    """The ten matrices of every block, in ``STACK_ORDER``, as one flat
    tensor of tile images in the weights' type, block after block: what the
    ``wgmma`` kernels' producers copy, 16 KB a stage, into their rings.  The
    training weights change every step, so a train step arranges them once,
    in the forward (``.calls`` counts the arrangements)."""
    from tsdiff_tpu_torch.ops.packed_score import tile_image

    arrange_stack_weights.calls += 1
    mats = [w[k[:-2]].transpose(-1, -2) if k.endswith("_t") else w[k] for k in STACK_ORDER]
    return tile_image(torch.stack(mats, dim=1)).reshape(-1)   # (L, 10, H*H) flat


def ea_tile_images(ea: torch.Tensor) -> torch.Tensor:
    """``ea (B, P, E)`` as the ``wgmma`` kernels' producers fetch it: per
    graph P / 64 tile images of 64 rows, ``(B, P*E)`` (``.calls`` counts
    them)."""
    from tsdiff_tpu_torch.ops.condensed_score import TILE_ROWS
    from tsdiff_tpu_torch.ops.packed_score import tile_image

    ea_tile_images.calls += 1
    return tile_image(ea, TILE_ROWS)


arrange_stack_weights.calls = 0
ea_tile_images.calls = 0


def _blocks_schedule(*groups: tuple[tuple[str, ...], int]) -> list[tuple[str, int]]:
    """``(matrix, 32-column block)`` per stage: each group's matrices, every
    one's stages in order, the group repeated its count of times."""
    from tsdiff_tpu_torch.ops.condensed_score import STAGE_COLS

    blocks = range(256 // STAGE_COLS)
    return [(k, c) for keys, times in groups for _ in range(times) for k in keys for c in blocks]


def stack_fwd_schedule(N: int) -> list[tuple[str, int]]:
    """The static schedule of weight stages every CTA of the ``wgmma``
    forward walks per block (a launch walks it L times), producer and
    consumers alike: ``(matrix, 32-column block)`` per stage.  The node
    product xh; per tile pair s1 and w; the node update's two products."""
    from tsdiff_tpu_torch.ops.condensed_score import dense_tile_pairs

    return _blocks_schedule((("l1w_t",), 1), (("f1w_t", "f2w_t"), dense_tile_pairs(N)),
                            (("l2w_t", "ow_t"), 1))


def stack_bwd_schedule(N: int) -> list[tuple[str, int]]:
    """The static schedule of weight stages every CTA of the ``wgmma`` row
    kernel walks in one launch (one block), producer and consumers alike:
    ``(matrix, 32-column block)`` per stage.  The node product xh; per tile
    pair a1 and a2 (pass 1); the node products a3, ds3 and dagg; per tile
    pair ds1 and dea (pass 2); the node product dh."""
    from tsdiff_tpu_torch.ops.condensed_score import dense_tile_pairs

    pairs = dense_tile_pairs(N)
    return _blocks_schedule((("l1w_t",), 1), (("f1w_t", "f2w_t"), pairs),
                            (("l2w_t", "ow", "l2w"), 1), (("f2w", "f1w"), pairs), (("l1w",), 1))


def dxh_by_source(wv: torch.Tensor, dagg: torch.Tensor) -> torch.Tensor:
    """The ``wgmma`` row kernel's pass-2 sum, in its order: for ``wv (N*N,
    F)`` and ``dagg (N, F)`` of one graph in the working type, ``dxh[i] =
    sum_j rnd(wv[i*N+j] * dagg[j])`` in float32, tile pair after tile pair,
    and inside a pair each source's targets ``j`` ascending.  Equal to the
    plain version's sum up to the order of the float32 additions."""
    from tsdiff_tpu_torch.ops.condensed_score import TILE_ROWS, dense_tile_pairs

    N, F = dagg.shape
    P = N * N
    dxh = torch.zeros((N, F), dtype=torch.float32)
    for tp in range(dense_tile_pairs(N)):
        pr0 = 2 * TILE_ROWS * tp
        for pr in range(pr0, min(P, pr0 + 2 * TILE_ROWS)):
            i, j = divmod(pr, N)
            dxh[i] += (wv[pr] * dagg[j]).float()
    return dxh


def xty_schedule(pair_rows: int, node_rows: int, ctas: int) -> dict:
    """The ``wgmma`` weight-gradient kernel's work for one block at H = 256,
    a pure function of the row counts and the number of CTAs (one per SM).

    The ten outputs, ``2 * job + mt`` (``XTY_JOBS``' job, rows ``XTY_TILE_M *
    mt`` onward of its gradient), each reduce over ``ceil(rows / 64)``
    stages of ``XTY_STAGE_ROWS`` rows (the last one zero-filled past the
    end).  Their stage-units, in the order (job, M-tile, stage), are dealt in
    equal ranges ``[c*T // ctas, (c+1)*T // ctas)`` to the CTAs (at most one
    CTA per unit), so that every CTA does the same work within one stage and
    no wave is left part full.  A range is cut where an output ends: each
    piece is a segment ``(job, mt, first stage, end stage)`` with an f32
    partial of its own, and the outputs' partials are summed in segment
    order.  Returns ``{"ctas", "segments", "cta_begin" (ctas + 1 segment
    indices), "out_begin" (11)}``."""
    stages = [math.ceil(r / XTY_STAGE_ROWS) for r in (pair_rows,) * 2 + (node_rows,) * 3]
    sizes = [stages[k // 2] for k in range(2 * len(stages))]
    starts = [sum(sizes[:k]) for k in range(len(sizes) + 1)]
    total = starts[-1]
    ctas = min(ctas, total)
    segments, cta_begin = [], []
    for c in range(ctas):
        lo, hi = c * total // ctas, (c + 1) * total // ctas
        cta_begin.append(len(segments))
        for k in range(len(sizes)):
            a, b = max(lo, starts[k]), min(hi, starts[k + 1])
            if a < b:
                segments.append((k // 2, k % 2, a - starts[k], b - starts[k]))
    cta_begin.append(len(segments))
    out_begin = [next(i for i, sg in enumerate(segments) if 2 * sg[0] + sg[1] == k)
                 for k in range(len(sizes))] + [len(segments)]
    return {"ctas": ctas, "segments": segments, "cta_begin": cta_begin, "out_begin": out_begin}


def xty_schedule_table(schedule: dict) -> list[int]:
    """``xty_schedule`` as the kernel reads it (int32): ``cta_begin``, then
    ``out_begin``, then the four numbers of each segment."""
    return (schedule["cta_begin"] + schedule["out_begin"]
            + [v for sg in schedule["segments"] for v in sg])


_xty_tables: dict = {}


def _xty_table(pair_rows: int, node_rows: int, device: torch.device):
    """``(table on the device, ctas, segments)`` for these row counts, made
    once per device and shape."""
    key = (pair_rows, node_rows, device)
    if key not in _xty_tables:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        sched = xty_schedule(pair_rows, node_rows, sms)
        # from pinned memory, without waiting: a copy from pageable memory
        # would first wait for all the work queued on the stream.  The pinned
        # tensor is kept with the table, so it outlives the copy.
        host = torch.tensor(xty_schedule_table(sched), dtype=torch.int32).pin_memory()
        table = host.to(device, non_blocking=True)
        _xty_tables[key] = (table, sched["ctas"], len(sched["segments"]), host)
    return _xty_tables[key][:3]


def schnet_stack_cost(B: int, N: int, H: int, L: int, dtype: torch.dtype, kind: str) -> dict:
    """Work of one call of ``kind`` "fwd" (B3's forward), "stack" (B4) or
    "bwd" (B3's backward), for its bound (E = F = H, P = N*N); "bwd_rows"
    and "bwd_xty" split the backward into its row kernels and its
    weight-gradient kernels.

    Forward flop: the TPU kernel's estimate (``schnet_stack.py:129-132``),
    ``2*B*L*(P*E*F + P*F*F + N*H*F + N*F*H + N*H*H)``.  Backward flop, from
    ``_bwd_kernel``'s body: 4 recomputed products (a1: P*E*F, a2: P*F*F,
    xh: N*H*F, a3: N*F*H), 4 pair-row products (df2w and ds1: P*F*F; df1w
    and dea: P*E*F) and 6 node products (dow and ds3: N*H*H; dl2w and dagg:
    N*F*H; dl1w and dh: N*H*F), i.e. ``2*B*L*(3*P*E*F + 3*P*F*F + 3*N*H*F +
    3*N*F*H + 2*N*H*H)``.  The elementwise aggregation products are not
    counted.  Bytes: every input read once and every output written once.

    The row kernels' share: the 4 recomputed products and ds3, dagg, ds1,
    dea and dh, ``2*B*L*(2*P*E*F + 2*P*F*F + 5*N*H*H)``; their outputs are dh,
    dea and, per block, the scratch the weight-gradient kernels read (5 pair
    and 6 node tensors in the working type) with the bias partials.  The
    weight-gradient kernels' share: the 5 products ``X^T Y``,
    ``2*B*L*(P*E*F + P*F*F + 3*N*H*H)``, reading their ten operands once per
    block and writing the nine gradients."""
    P, E = N * N, H
    t = torch.finfo(dtype).bits // 8
    weights = L * (5 * H * H + 4 * H) * t
    scratch = L * (5 * B * P * H + 6 * B * N * H) * t
    grads = L * (5 * H * H + 4 * H) * 4
    if kind == "bwd_rows":
        flops = 2 * B * L * (2 * P * E * H + 2 * P * H * H + 5 * N * H * H)
        nbytes = (B * P * (E + 1) + B * L * N * H) * t + B * N * H * 4 + weights \
            + (B * N * H + B * P * E) * 4 + scratch + L * 4 * B * H * 4
        return {"flops": flops, "bytes": nbytes}
    if kind == "bwd_xty":
        flops = 2 * B * L * (P * E * H + P * H * H + 3 * N * H * H)
        # per block: X = ea, s1, hl, agg, s3 and Y = da1, da2, dxh, da3, gd
        return {"flops": flops, "bytes": L * (4 * B * P * H + 6 * B * N * H) * t + grads}
    if kind == "bwd":
        flops = 2 * B * L * (3 * P * E * H + 3 * P * H * H + 3 * N * H * H + 3 * N * H * H
                             + 2 * N * H * H)
        nbytes = (B * P * (E + 1) + B * L * N * H + B * N * H) * t + weights \
            + (B * N * H + B * P * E + L * (5 * H * H + 4 * H)) * 4
    else:
        flops = 2 * B * L * (P * E * H + P * H * H + 3 * N * H * H)
        hs = B * L * N * H if kind == "fwd" else 0
        nbytes = (B * P * (E + 1) + B * N * H) * t + weights + (B * N * H + hs) * t
    return {"flops": flops, "bytes": nbytes}


# ---------------------------------------------------------------------------
# Kernel wrappers


def _check(w: dict, ea: torch.Tensor, c: torch.Tensor, nodes: torch.Tensor, name: str):
    """Shapes, types and devices the kernels take; returns (B, N, H, L)."""
    dt = ea.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: the working type must be float32 or bfloat16, got {dt}")
    B, N, H = nodes.shape[0], nodes.shape[-2], nodes.shape[-1]
    L = w["f1w"].shape[0]
    if N % 8 or H % 64 or H > 256:
        raise ValueError(f"{name}: the CUDA kernels need N % 8 == 0 and H a multiple of 64 "
                         f"up to 256, got N={N}, H={H}")
    want = {"ea": (ea, (B, N * N, H)), "c": (c, (B, N * N))}
    for k in W_KEYS:
        want[k] = (w[k], (L, H, H) if k in _MATS else (L, H))
    for k, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != dt or t.device != nodes.device:
            raise ValueError(f"{name}: {k} must be a {dt} {shape} tensor on {nodes.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if nodes.dtype != dt:
        raise ValueError(f"{name}: node tensors must be {dt}, got {nodes.dtype}")
    return B, N, H, L


def _launch(fn_name: str, tensors: list, *ints):
    lib = _kernel_lib()
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{fn_name}: every tensor must be contiguous")
    ptrs = (ctypes.c_void_p * len(tensors))(*[0 if t is None else t.data_ptr() for t in tensors])
    dev = tensors[0].device
    with torch.cuda.device(dev):
        err = getattr(lib, fn_name)(ptrs, *ints, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.schnet_stack_error_string(err).decode()
        raise RuntimeError(f"{fn_name} failed ({err}: {msg}) with arguments {ints}")


def _wg_operands(w: dict, ea: torch.Tensor, L: int, image, ea_img, name: str):
    """The ``wgmma`` kernels' arranged weights and ``ea`` tile images, made
    here where not given; a misshaped one raises."""
    B, P, H = ea.shape
    image = arrange_stack_weights(w) if image is None else image
    ea_img = ea_tile_images(ea) if ea_img is None else ea_img
    for t, shape, what in ((image, (L * len(STACK_ORDER) * H * H,), "arrange_stack_weights"),
                           (ea_img, (B, P * H), "ea_tile_images")):
        if tuple(t.shape) != shape or t.dtype != ea.dtype or not t.is_contiguous() \
                or t.device != ea.device:
            raise ValueError(f"{name}: {what}'s tensor must be a contiguous {ea.dtype} {shape} "
                             f"tensor on {ea.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return image, ea_img


def _fwd_uses_wg(N: int, H: int, dtype: torch.dtype) -> bool:
    return bool(_kernel_lib().schnet_stack_fwd_uses_wg(N, H, int(dtype == torch.bfloat16)))


def stack_wg_operands(w: dict, h: torch.Tensor, ea: torch.Tensor, c: torch.Tensor):
    """``(image, ea_img)`` for the ``wgmma`` kernels, to be made once and
    given to the forward and the backward of one step; ``(None, None)`` for
    CPU tensors (the plain versions) and for shapes that take the
    ``mma.sync`` kernels."""
    if h.device.type == "cpu":
        return None, None
    B, N, H, L = _check(w, ea, c, h, "schnet_stack")
    if not _fwd_uses_wg(N, H, ea.dtype):
        return None, None
    return _wg_operands(w, ea, L, None, None, "schnet_stack")


def _fwd_cuda(w: dict, h: torch.Tensor, ea: torch.Tensor, c: torch.Tensor, store_hs: bool,
              image, ea_img):
    """``(out, hs, took the wgmma kernel)``."""
    name = "schnet_stack forward"
    B, N, H, L = _check(w, ea, c, h, name)
    use_wg = _fwd_uses_wg(N, H, h.dtype)
    if use_wg:
        image, ea_img = _wg_operands(w, ea, L, image, ea_img, name)
        mats = [None if k in _MATS else w[k] for k in W_KEYS]   # read from the image
    else:
        image = ea_img = None
        mats = [w[k].transpose(1, 2).contiguous() if k in _MATS else w[k] for k in W_KEYS]
    out = torch.empty_like(h)
    hs = torch.empty((B, L, N, H), dtype=h.dtype, device=h.device) if store_hs else None
    _launch("schnet_stack_fwd_launch", [ea, c, h, *mats, out, hs, image, ea_img],
            B, N, H, L, int(h.dtype == torch.bfloat16), int(store_hs))
    return out, hs, use_wg


def schnet_stack_fwd(w: dict, h: torch.Tensor, ea: torch.Tensor, c: torch.Tensor,
                     image: torch.Tensor | None = None, ea_img: torch.Tensor | None = None):
    """B3's forward: ``(out, hs)``.  CPU tensors take the plain version;
    CUDA tensors launch the kernel on the current stream, or raise.

    Which kernel is decided by the shape alone, in the library: bfloat16 at
    H = 256 with N <= 24 takes the ``wgmma`` one (``.wg_launches`` counts
    those calls), which reads the weights as ``arrange_stack_weights`` lays
    them out and ``ea`` as ``ea_tile_images`` does (each made here unless
    given; a misshaped one raises); float32 and other shapes take the
    ``mma.sync`` one.  Neither gives way to the other, or to the plain
    version."""
    if h.device.type == "cpu":
        return schnet_stack_fwd_reference(w, h, ea, c)
    out, hs, use_wg = _fwd_cuda(w, h, ea, c, True, image, ea_img)
    schnet_stack_fwd.launches += 1
    schnet_stack_fwd.wg_launches += int(use_wg)
    return out, hs


def schnet_stack_bwd(w: dict, ea: torch.Tensor, c: torch.Tensor, hs: torch.Tensor,
                     g: torch.Tensor, image: torch.Tensor | None = None,
                     ea_img: torch.Tensor | None = None):
    """B3's backward: ``(dh, dea, grads)`` as ``schnet_stack_bwd_reference``.
    CPU tensors take the plain version; CUDA tensors run the kernels on the
    current stream, or raise.

    Which row kernel is decided by the shape alone, in the library: bfloat16
    at H = 256 with N <= 24 takes the ``wgmma`` one (``.wg_launches`` counts
    those calls), which reads the weights and ``ea`` as the ``wgmma``
    forward does (each made here unless given, as the forward of a train
    step gives them; a misshaped one raises); float32 and other shapes take
    the ``mma.sync`` one.  The weight gradients likewise: bfloat16 at H = 256
    takes the ``wgmma`` weight-gradient kernel (``.xty_wg_launches`` counts
    those calls; ``schnet_stack_xty`` runs it alone), everything else the
    ``mma.sync`` one.  Neither gives way to the other, or to the plain
    version."""
    if hs.device.type == "cpu":
        return schnet_stack_bwd_reference(w, ea, c, hs, g)
    name = "schnet_stack backward"
    B, N, H, L = _check(w, ea, c, hs[:, 0], name)
    if tuple(g.shape) != (B, N, H):
        raise ValueError(f"{name}: g must be ({B}, {N}, {H}), got {tuple(g.shape)}")
    dev, dt = ea.device, ea.dtype
    use_wg = bool(_kernel_lib().schnet_stack_bwd_uses_wg(N, H, int(dt == torch.bfloat16)))
    if use_wg:
        image, ea_img = _wg_operands(w, ea, L, image, ea_img, name)
    else:
        image = ea_img = None
    f32 = dict(dtype=torch.float32, device=dev)
    P = N * N
    dh = g.float().contiguous().clone()
    dea = torch.zeros((B, P, H), **f32)
    grads = {k: torch.empty(w[k].shape, **f32) for k in W_KEYS}
    pair = [torch.empty((B * P, H), dtype=dt, device=dev) for _ in range(5)]
    node = [torch.empty((B * N, H), dtype=dt, device=dev) for _ in range(6)]
    bias = torch.empty((4, B, H), **f32)
    use_xty_wg, part, table, ctas = _xty_plan(B * P, B * N, H, dt, dev)
    fwd_layout = [w[k].transpose(1, 2).contiguous() for k in ("f1w", "f2w", "l1w", "l2w")]
    tensors = [ea, c, hs, dh, dea, *fwd_layout,
               *(w[k] for k in ("f1w", "f2w", "l1w", "l2w", "ow", "f1b", "f2b", "l2b")),
               *(grads[k] for k in W_KEYS), *pair, *node, bias, part, image, ea_img, table]
    _launch("schnet_stack_bwd_launch", tensors, B, N, H, L, int(dt == torch.bfloat16),
            PAIR_ROWS_PER_SPLIT, NODE_ROWS_PER_SPLIT, ctas)
    schnet_stack_bwd.launches += 1
    schnet_stack_bwd.wg_launches += int(use_wg)
    schnet_stack_bwd.xty_wg_launches += int(use_xty_wg)
    return dh, dea, grads


def _xty_plan(pair_rows: int, node_rows: int, H: int, dt: torch.dtype, dev: torch.device):
    """``(takes the wgmma weight-gradient kernel, f32 partials, schedule table
    or None, CTAs)`` for one block's products: the kernel is decided by the
    shape alone, in the library."""
    f32 = dict(dtype=torch.float32, device=dev)
    lib = _kernel_lib()
    if lib.schnet_stack_bwd_xty_uses_wg(pair_rows, node_rows, H, int(dt == torch.bfloat16)):
        table, ctas, segments = _xty_table(pair_rows, node_rows, dev)
        return True, torch.empty((segments, XTY_TILE_M, H), **f32), table, ctas
    splits = 2 * math.ceil(pair_rows / PAIR_ROWS_PER_SPLIT) \
        + 3 * math.ceil(node_rows / NODE_ROWS_PER_SPLIT)
    return False, torch.empty((splits, H, H), **f32), None, 0


def schnet_stack_xty(xs: list, ys: list) -> torch.Tensor:
    """One block's five weight-gradient products alone, as B3's backward runs
    them: ``(5, H, H)`` float32, ``xs[k]^T ys[k]`` summed over all rows, in
    ``XTY_JOBS`` order; ``xs[k]``, ``ys[k]`` row-major ``(rows, H)``, jobs 0
    and 1 over the pair rows, 2-4 over the node rows.  CPU tensors take the
    plain version; CUDA tensors launch the kernel on the current stream, or
    raise.  bfloat16 at H = 256 takes the ``wgmma`` kernel (``.wg_launches``
    counts those calls), float32 and other widths the ``mma.sync`` one;
    neither gives way to the other, or to the plain version."""
    name = "schnet_stack_xty"
    if len(xs) != len(XTY_JOBS) or len(ys) != len(XTY_JOBS):
        raise ValueError(f"{name}: needs {len(XTY_JOBS)} X and {len(XTY_JOBS)} Y tensors")
    if xs[0].device.type == "cpu":
        return xty_reference(xs, ys)
    dt, dev, H = xs[0].dtype, xs[0].device, xs[0].shape[-1]
    rows = (xs[0].shape[0],) * 2 + (xs[2].shape[0],) * 3
    if dt not in (torch.float32, torch.bfloat16) or H % 64 or H > 256:
        raise ValueError(f"{name}: needs float32 or bfloat16 and H a multiple of 64 up to 256, "
                         f"got {dt}, H={H}")
    for k, t in enumerate(list(xs) + list(ys)):
        shape = (rows[k % len(XTY_JOBS)], H)
        if tuple(t.shape) != shape or t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: operand {k} must be a contiguous {dt} {shape} tensor on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    use_wg, part, table, ctas = _xty_plan(rows[0], rows[2], H, dt, dev)
    out = torch.empty((len(XTY_JOBS), H, H), dtype=torch.float32, device=dev)
    _launch("schnet_stack_xty_launch", [*xs, *ys, out, part, table], rows[0], rows[2], H,
            int(dt == torch.bfloat16), PAIR_ROWS_PER_SPLIT, NODE_ROWS_PER_SPLIT, ctas)
    schnet_stack_xty.launches += 1
    schnet_stack_xty.wg_launches += int(use_wg)
    return out


def prepare_inputs(weights: dict, h, edge_attr, cmask, dtype):
    """The JAX-package call's casts: weights, ea (B, P, E), c (B, P) and h in
    ``dtype``, contiguous."""
    B, N, _, E = edge_attr.shape
    w = {k: weights[k].to(dtype).contiguous() for k in W_KEYS}
    ea = edge_attr.reshape(B, N * N, E).to(dtype).contiguous()
    c = cmask.reshape(B, N * N).to(dtype).contiguous()
    return w, h.to(dtype).contiguous(), ea, c


def interaction_stack_pallas(weights: dict, h: torch.Tensor, edge_attr: torch.Tensor,
                             cmask: torch.Tensor, dtype=torch.float32,
                             image: torch.Tensor | None = None,
                             ea_img: torch.Tensor | None = None) -> torch.Tensor:
    """B4: the forward-only stack, ``(B, N, H)`` in ``dtype``, from the JAX
    package's arguments (``edge_attr (B, N, N, E)``, ``cmask (B, N, N)``).
    CPU tensors take the plain version; CUDA tensors launch B3's forward
    kernel built without the ``hs`` store (the ``wgmma`` one where
    ``schnet_stack_fwd`` takes it, counted in ``.wg_launches``, with its
    image and ``ea`` tile images made here unless given), or raise."""
    w, h, ea, c = prepare_inputs(weights, h, edge_attr, cmask, dtype)
    if h.device.type == "cpu":
        return interaction_stack_reference(w, h, ea, c)
    out, _, use_wg = _fwd_cuda(w, h, ea, c, False, image, ea_img)
    interaction_stack_pallas.launches += 1
    interaction_stack_pallas.wg_launches += int(use_wg)
    return out


schnet_stack_fwd.launches = schnet_stack_fwd.wg_launches = 0
schnet_stack_bwd.launches = schnet_stack_bwd.wg_launches = schnet_stack_bwd.xty_wg_launches = 0
schnet_stack_xty.launches = schnet_stack_xty.wg_launches = 0
interaction_stack_pallas.launches = interaction_stack_pallas.wg_launches = 0


class InteractionStackFn(torch.autograd.Function):
    """B3 as an autograd function: the forward kernel saves the block inputs
    ``hs``; the backward kernels recompute from them.  On the card the
    forward makes the ``wgmma`` kernels' weight image and ``ea`` tile images
    once and saves them for the backward.  Gradients come back in the
    inputs' types, as ``_bwd_rule`` casts them; ``cmask`` gets none."""

    @staticmethod
    def forward(ctx, f1w, f1b, f2w, f2b, l1w, l2w, l2b, ow, ob, h, edge_attr, cmask, dtype):
        weights = dict(zip(W_KEYS, (f1w, f1b, f2w, f2b, l1w, l2w, l2b, ow, ob)))
        w, hv, ea, c = prepare_inputs(weights, h, edge_attr, cmask, dtype)
        image, ea_img = stack_wg_operands(w, hv, ea, c)
        out, hs = schnet_stack_fwd(w, hv, ea, c, image=image, ea_img=ea_img)
        ctx.save_for_backward(*(w[k] for k in W_KEYS), ea, c, hs, image, ea_img)
        ctx.meta = (h.dtype, edge_attr.shape, edge_attr.dtype, [weights[k].dtype for k in W_KEYS])
        return out

    @staticmethod
    def backward(ctx, g):
        *ws, ea, c, hs, image, ea_img = ctx.saved_tensors
        h_dtype, ea_shape, ea_dtype, w_dtypes = ctx.meta
        w = dict(zip(W_KEYS, ws))
        dh, dea, grads = schnet_stack_bwd(w, ea, c, hs, g.to(ea.dtype).contiguous(),
                                          image=image, ea_img=ea_img)
        dws = [grads[k].to(dt) for k, dt in zip(W_KEYS, w_dtypes)]
        return (*dws, dh.to(h_dtype), dea.reshape(ea_shape).to(ea_dtype), None, None)


def interaction_stack_pallas_trainable(weights: dict, h: torch.Tensor, edge_attr: torch.Tensor,
                                       cmask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """B3: the differentiable fused stack, ``(B, N, H)`` in ``dtype``."""
    return InteractionStackFn.apply(*(weights[k] for k in W_KEYS), h, edge_attr, cmask, dtype)
