"""The host side of the ``wgmma`` row kernel of B3's backward, on the CPU:
the image of each block's weight matrices it copies into shared memory,
its static schedule of weight stages, ``ea`` as 64-row tile images, its
fixed-order pass-2 sum, and the wrapper's choice of the plain version for CPU
tensors, which never builds the image."""

import math

import pytest
import torch

from tsdiff_tpu_torch.ops import condensed_score as cs
from tsdiff_tpu_torch.ops import packed_score as ps
from tsdiff_tpu_torch.ops import schnet_stack as ss


def stack_weights(L, H=256, seed=0, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)

    def t(*shape):
        return (torch.randn(*shape, generator=g) / math.sqrt(shape[-1])).to(dtype).contiguous()

    return dict(f1w=t(L, H, H), f1b=t(L, H), f2w=t(L, H, H), f2b=t(L, H), l1w=t(L, H, H),
                l2w=t(L, H, H), l2b=t(L, H), ow=t(L, H, H), ob=t(L, H))


@pytest.mark.parametrize("L", [2, 7])
def test_stack_bwd_image_round_trip(L):
    """One flat tensor of the ten matrices per block, block after block (the
    row kernel reads the first nine); its inverse gives back f1w, f2w, l1w,
    l2w transposed (the forward products' B operands) and ow, l2w, f2w, f1w,
    l1w as they are (the backward's)."""
    H = 256
    w = stack_weights(L, seed=L)
    image = ss.arrange_stack_weights(w)
    assert image.shape == (L * 10 * H * H,) and image.dtype == torch.bfloat16
    assert image.is_contiguous()
    mats = ps.tile_image_inverse(image.reshape(L, 10, H * H), H, H)
    back = {k: mats[:, m] for m, k in enumerate(ss.STACK_ORDER)}
    for k in ("f1w", "f2w", "l1w", "l2w"):
        assert torch.equal(back[f"{k}_t"], w[k].transpose(-1, -2)), k
    for k in ("ow", "l2w", "f2w", "f1w", "l1w"):
        assert torch.equal(back[k], w[k]), k
    # where the producer looks for stage c of matrix m of block l
    # (csrc/schnet_stack.cu: wimg + (l * 10 + m) * H * H + c * 32 * H)
    stage = cs.STAGE_COLS * H
    for name, l, c in (("l1w_t", 0, 0), ("f2w_t", L - 1, 5), ("ow", 1, 7), ("l1w", L - 1, 3)):
        m = ss.STACK_ORDER.index(name)
        mat = w[name[:-2]][l].t() if name.endswith("_t") else w[name][l]
        start = (l * 10 + m) * H * H + c * stage
        assert torch.equal(ps.tile_image_inverse(image[start:start + stage], cs.STAGE_COLS, H),
                           mat[c * cs.STAGE_COLS:(c + 1) * cs.STAGE_COLS]), name


@pytest.mark.parametrize("N,pairs", [(8, 1), (16, 2), (24, 5)])
def test_stack_bwd_schedule_by_hand(N, pairs):
    """Per launch (one block), in matrices of 8 stages: the node products xh,
    a3, ds3, dagg and dh, and per tile pair a1, a2 (pass 1) and ds1, dea
    (pass 2)."""
    assert cs.dense_tile_pairs(N) == pairs
    sched = ss.stack_bwd_schedule(N)
    assert len(sched) == 8 * (5 + 4 * pairs)
    blocks = [(c,) for c in range(8)]
    assert [s[1:] for s in sched[:8]] == blocks and {s[0] for s in sched[:8]} == {"l1w_t"}
    pass1 = sched[8:8 + 16 * pairs]
    assert pass1 == ([("f1w_t", c) for c in range(8)] + [("f2w_t", c) for c in range(8)]) * pairs
    node = sched[8 + 16 * pairs:32 + 16 * pairs]
    assert [k for k, _ in node[::8]] == ["l2w_t", "ow", "l2w"]
    pass2 = sched[32 + 16 * pairs:-8]
    assert pass2 == ([("f2w", c) for c in range(8)] + [("f1w", c) for c in range(8)]) * pairs
    assert sched[-8:] == [("l1w", c) for c in range(8)]
    assert {k for k, _ in sched} == set(ss.STACK_ORDER[:9])
    # at the training shape: 200 stages of 16 KB per CTA and block
    if N == 24:
        assert len(sched) == 200


@pytest.mark.parametrize("N", [8, 16, 24])
def test_ea_tile_images(N):
    """``ea (B, P, E)`` as the row kernel's producer fetches it: per graph
    P / 64 tile images of 32 KB, tile ti holding rows 64 ti .. 64 ti + 63."""
    B, H = 2, 256
    g = torch.Generator().manual_seed(N)
    ea = torch.randn(B, N * N, H, generator=g).to(torch.bfloat16)
    img = ps.tile_image(ea, cs.TILE_ROWS)
    assert img.shape == (B, N * N * H)
    tile = cs.TILE_ROWS * H
    for b, ti in ((0, 0), (B - 1, N * N // 64 - 1)):
        block = img[b, ti * tile:(ti + 1) * tile]
        assert torch.equal(ps.tile_image_inverse(block, cs.TILE_ROWS, H, cs.TILE_ROWS),
                           ea[b, ti * 64:(ti + 1) * 64])


@pytest.mark.parametrize("N", [8, 16, 24])
def test_dxh_by_source_equals_the_reference_sum(N):
    """The kernel's pass-2 sum, stated in its order (tile pair after tile
    pair, each source's targets ascending), against the plain version's
    ``(w3 * dagg).sum(2)``: the same rounded terms, float32 sums in another
    order; and since the pairs cover the rows in order, equal bit for bit to
    one plain ascending loop over j."""
    g = torch.Generator().manual_seed(N)
    F = 64
    wv = torch.randn(N * N, F, generator=g).to(torch.bfloat16)
    dagg = torch.randn(N, F, generator=g).to(torch.bfloat16)
    dxh = ss.dxh_by_source(wv, dagg)
    ref = (wv.reshape(N, N, F) * dagg[None, :, :]).float().sum(1)
    torch.testing.assert_close(dxh, ref, rtol=1e-5, atol=1e-5)
    ascending = torch.zeros(N, F)
    for j in range(N):
        ascending += (wv.reshape(N, N, F)[:, j] * dagg[j]).float()
    assert torch.equal(dxh, ascending)
    # a source whose whole mask row is zero (w = 0 there) gets nothing
    w0 = wv.clone().reshape(N, N, F)
    w0[1] = 0
    assert torch.equal(ss.dxh_by_source(w0.reshape(N * N, F), dagg)[1], torch.zeros(F))


def test_cpu_tensors_take_the_plain_version_and_never_build_the_image(monkeypatch):
    """CPU bf16 tensors at a shape the wgmma row kernel would take go to the
    plain version; the wrapper neither arranges the weights nor counts a
    launch."""
    def refuse(_w):
        raise AssertionError("the image was built for CPU tensors")

    monkeypatch.setattr(ss, "arrange_stack_weights", refuse)
    B, N, H, L = 2, 8, 256, 1
    w = stack_weights(L, seed=3)
    g = torch.Generator().manual_seed(4)
    h = torch.randn(B, N, H, generator=g).to(torch.bfloat16)
    ea = torch.randn(B, N * N, H, generator=g).to(torch.bfloat16)
    c = (torch.rand(B, N * N, generator=g) < 0.7).to(torch.bfloat16)
    cot = torch.randn(B, N, H, generator=g).to(torch.bfloat16)
    _, hs = ss.schnet_stack_fwd_reference(w, h, ea, c)
    calls = ss.schnet_stack_bwd_reference.calls
    launches = ss.schnet_stack_bwd.launches, ss.schnet_stack_bwd.wg_launches
    dh, dea, grads = ss.schnet_stack_bwd(w, ea, c, hs, cot)
    assert ss.schnet_stack_bwd_reference.calls == calls + 1
    assert (ss.schnet_stack_bwd.launches, ss.schnet_stack_bwd.wg_launches) == launches
    assert dh.shape == (B, N, H) and dea.shape == (B, N * N, H)
    assert set(grads) == set(ss.W_KEYS) and all(v.dtype == torch.float32 for v in grads.values())
