"""The host side of the warp-specialised dense score kernel (B2), on the CPU:
the weight image it copies into shared memory, its dense row table, its
static schedule of weight stages with its L2 traffic, its fixed-order
aggregation, and the wrapper's choice of the plain version for CPU tensors
whose dictionary carries the arranged entry."""

import math
import os

import numpy as np
import pytest
import torch

from tsdiff_tpu_torch.ops import condensed_score as cs
from tsdiff_tpu_torch.ops import packed_score as ps
from tsdiff_tpu_torch.ops import schnet_stack as ss


def dense_weights(L, H=256, seed=0, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)

    def t(*shape):
        return (torch.randn(*shape, generator=g) / math.sqrt(shape[-1])).to(dtype)

    w = dict(
        dw0=t(H), db0=t(H), dw1=t(H, H), db1=t(H), c0r=t(H, H), c0p=t(H, H), c0b=t(H),
        c1w=t(H, H), c1b=t(H), f1w=t(L, H, H), f1b=t(L, H), f2w=t(L, H, H), f2b=t(L, H),
        l1w=t(L, H, H), l2w=t(L, H, H), l2b=t(L, H), ow=t(L, H, H), ob=t(L, H),
        g0h=t(H, H), g0e=t(H, H), g0b=t(H), g1w=t(H // 2, H), g1b=t(H // 2), g2w=t(H // 2),
        g2b=t(1),
    )
    return {k: w[k].contiguous() for k in cs.W_ORDER}


def test_dense_image_layout_and_round_trip():
    """One model's image: the packed kernel's matrices in its order, a 1-D
    tensor, and its inverse gives every matrix back."""
    L, H = 3, 256
    w = dense_weights(L)
    aw = cs.with_wg_image(w)
    image = aw[cs.WG_IMAGE]
    assert cs.WG_IMAGE == ps.WG_IMAGE
    assert image.shape == ((13 + 10 * L) * (H * H // 2),) and image.dtype == torch.bfloat16
    assert image.is_contiguous()
    back = ps.split_image(image, L)
    for k in ps.IMAGE_ORDER:
        assert torch.equal(back[k], w[k]), k
    # where the kernel's producer looks for stage c of a matrix: unit offsets
    # as csrc/condensed_score.cu::DenseImage states them
    HH, stage = H * H, cs.STAGE_COLS * H
    unit = {"dw1": 0, "c0r": 1, "c0p": 2, "c1w": 3, "f1w": 4, "f2w": 4 + L, "l1w": 4 + 2 * L,
            "l2w": 4 + 3 * L, "ow": 4 + 4 * L, "g0h": 4 + 5 * L, "g0e": 5 + 5 * L, "g1w": 6 + 5 * L}
    for name, l, c in (("dw1", 0, 3), ("f1w", 2, 7), ("ow", 1, 0), ("g1w", 0, 3)):
        mat = w[name][l] if w[name].dim() == 3 else w[name]
        start = (unit[name] + l) * HH + c * stage
        block = image[start:start + stage]
        assert torch.equal(ps.tile_image_inverse(block, cs.STAGE_COLS, H),
                           mat[c * cs.STAGE_COLS:(c + 1) * cs.STAGE_COLS])
    # the entries the kernel takes stay as they were
    for k in cs.W_ORDER:
        assert aw[k] is w[k]


@pytest.mark.parametrize("N,pairs", [(8, 1), (16, 2), (24, 5)])
def test_dense_schedule_and_l2_bytes_by_hand(N, pairs):
    L, B = 7, 100
    assert cs.dense_tile_pairs(N) == pairs
    sched = cs.dense_schedule(N, L)
    # by hand, in matrices of 8 stages: per tile pair edge_cat 4 (dw1, c0r,
    # c0p, c1w) in the encoder and again in the head, the head's g0h, g0e and
    # half a g1w; per block the node products l1w, l2w, ow and f1w, f2w per
    # tile pair
    matrices = pairs * (4 + 4 + 2.5) + L * (3 + 2 * pairs)
    assert len(sched) == int(matrices * 8)
    assert cs.wg_dense_l2_weight_bytes(B, N, L) == B * len(sched) * 16384
    i = sched.index(("c0r", 0, 0))
    assert sched[i:i + 4] == [("c0r", 0, 0), ("c0p", 0, 0), ("c0r", 0, 1), ("c0p", 0, 1)]
    assert sched[-4:] == [("g1w", 0, c) for c in range(4)]
    assert {s[0] for s in sched} == set(ps.IMAGE_ORDER)
    # the mma.sync kernel reads each matrix once per 64-row tile
    tiles = N * N // 64
    assert cs.mma_sync_dense_l2_weight_bytes(B, N, L) == \
        int(B * (tiles * 24.5 + 21) * 256 * 256 * 2)
    # a stage serves both tiles of a pair; with one tile (N=8) nothing is shared
    wg, mma = cs.wg_dense_l2_weight_bytes(B, N, L), cs.mma_sync_dense_l2_weight_bytes(B, N, L)
    assert wg < mma if tiles > 1 else wg == mma


def test_dense_schedule_at_the_dense_path_shape():
    """B=100, N=24, L=7: 143.5 matrices of 128 KB per CTA, 1.88 GB of weight
    stages per launch, against 241.5 matrices (3.17 GB) for the mma.sync kernel."""
    assert len(cs.dense_schedule(24, 7)) == 1148
    assert cs.wg_dense_l2_weight_bytes(100, 24, 7) == 100 * 1148 * 16384
    assert cs.mma_sync_dense_l2_weight_bytes(100, 24, 7) == int(100 * 241.5 * 131072)
    # the packed schedule is the same walk over fewer tile pairs, B1's filter
    # chain taking f1w's stages and f2w's K-blocks in turn
    packed, plain = ps.wg_schedule(24, 7), cs.stage_schedule(3, 7)
    assert sorted(packed) == sorted(plain)
    assert [s for s in packed if s[0] not in ("f1w", "f2w")] == \
        [s for s in plain if s[0] not in ("f1w", "f2w")]


@pytest.mark.parametrize("N", [8, 16, 24])
def test_dense_row_table(N):
    table = cs.dense_row_pairs(N)
    assert table.shape == (N * N, 2) and table.dtype == torch.int64
    i, j = np.divmod(np.arange(N * N), N)
    np.testing.assert_array_equal(table[:, 0].numpy(), i)
    np.testing.assert_array_equal(table[:, 1].numpy(), j)
    assert int(table.max()) < N <= 255          # the kernel keeps the table in bytes


@pytest.mark.parametrize("N", [8, 16, 24])
def test_dense_aggregation_by_node_equals_the_reference_sum(N):
    """The kernel's per-node statement of the dense aggregation, sources in
    order, against the plain version's sum (``ops.schnet_stack._aggregate``,
    which the dense reference runs): the same rounded terms, float32 sums in
    another order."""
    g = torch.Generator().manual_seed(N)
    F = 64
    w = torch.randn(N * N, F, generator=g).to(torch.bfloat16)
    xh = torch.randn(N, F, generator=g).to(torch.bfloat16)
    agg = cs.aggregate_dense_by_node(w, xh)
    ref = (w.reshape(N, N, F) * xh[:, None, :]).float().sum(0)
    torch.testing.assert_close(agg, ref, rtol=1e-5, atol=1e-5)
    # rounded to the working type as the node update does: within one bf16 ulp
    rounded = ss._aggregate(w[None], xh[None])[0]
    torch.testing.assert_close(agg.to(torch.bfloat16).float(), rounded.float(),
                               rtol=2 ** -7, atol=1e-6)
    # a zero filter row of a source (cmask 0) adds nothing
    w0 = w.clone().reshape(N, N, F)
    w0[1] = 0
    ref0 = (w0 * xh[:, None, :]).float().sum(0)
    torch.testing.assert_close(cs.aggregate_dense_by_node(w0.reshape(N * N, F), xh), ref0,
                               rtol=1e-5, atol=1e-5)


def dense_cpu_inputs(B, N, H, seed):
    g = torch.Generator().manual_seed(seed)
    z = torch.randn(B, N, H, generator=g).to(torch.bfloat16)
    m = torch.triu(torch.rand(B, N, N, generator=g) < 0.7, 1)
    m = m | m.transpose(1, 2)
    d = torch.where(m, 0.8 + 4 * torch.rand(B, N, N, generator=g), torch.ones(B, N, N))
    embs = [torch.randn(B, N, N, H, generator=g).to(torch.bfloat16) for _ in range(4)]
    return z, d, m.float(), embs


def test_cpu_tensors_take_the_plain_version_with_the_arranged_entry():
    B, N, L = 2, 8, 1
    bare = dense_weights(L)
    w = cs.with_wg_image(bare)
    z, d, cmask, embs = dense_cpu_inputs(B, N, 256, seed=1)
    calls = cs.condensed_score_reference.calls
    launches, wg = cs.condensed_score.launches, cs.condensed_score.wg_launches
    out = cs.condensed_score(w, z, d, cmask, *embs, num_blocks=L)
    assert cs.condensed_score_reference.calls == calls + 1
    assert (cs.condensed_score.launches, cs.condensed_score.wg_launches) == (launches, wg)
    ref = cs.condensed_score_reference(bare, z, d, cmask, *embs, num_blocks=L)
    assert out.shape == ref.shape == (B, N, N, 1)
    # a CPU matrix product may split its float32 sums differently from call
    # to call, and a bf16 rounding then flips
    torch.testing.assert_close(out, ref, rtol=0, atol=3e-2 * ref.abs().max().item())
    # the bound reads the same work with and without the arranged copy
    assert cs.condensed_score_cost(w, z, L) == cs.condensed_score_cost(bare, z, L)


def test_model_fused_weights_carry_the_image_in_bf16_only():
    """``fused_weights()`` of the production model (H=256) adds the arranged
    entry in bfloat16, where the wgmma kernel takes it, and not in float32."""
    from tsdiff_tpu_torch.config import Config
    from tsdiff_tpu_torch.models import CondenseEncoderEpsNetwork
    from tsdiff_tpu_torch.train import load_checkpoint

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ck = load_checkpoint(os.path.join(repo, "artifacts", "seeds", "ckpts", "seed106_best.ckpt"))
    cfg = Config({**ck["config"]["model"], "fused_score": True})
    w = CondenseEncoderEpsNetwork.from_config(cfg, dtype=torch.bfloat16).fused_weights()
    assert set(w) == set(cs.W_ORDER) | {cs.WG_IMAGE}
    assert torch.equal(w[cs.WG_IMAGE], ps.arrange_weights({k: w[k] for k in ps.IMAGE_ORDER}))
    assert w[cs.WG_IMAGE].dtype == torch.bfloat16
    model32 = CondenseEncoderEpsNetwork.from_config(cfg, dtype=torch.float32)
    assert set(model32.fused_weights()) == set(cs.W_ORDER)
