"""The host side of the warp-specialised packed score kernel, on the CPU: the
weight image it copies into shared memory, the packed-row table, the static
schedule of weight stages with its L2 traffic, and the wrappers' choice of the
plain version for CPU tensors whose dictionary carries the arranged entries.

The address map is stated here a second time, element by element in numpy,
independently of ``tile_image``'s reshapes: block of ``rows`` rows, atoms of
128 bytes per row, the 16-byte unit ``u`` of row ``r`` at unit ``u ^ (r % 8)``.
So is the K-block image of B1's filter chain (``kblock_image``): K-blocks of
32 columns, rows of 64 bytes, the unit ``u`` of row ``r`` at ``u ^ ((r >> 1) % 4)``.
"""

import math

import numpy as np
import pytest
import torch

from tsdiff_tpu_torch.core.packed import packed_index_arrays
from tsdiff_tpu_torch.ops import condensed_score as cs
from tsdiff_tpu_torch.ops import packed_score as ps
from tsdiff_tpu_torch.ops import packed_score_int8 as p8


def image_offset(n: int, k: int, K: int, itemsize: int, block_rows: int) -> int:
    """Element offset of (row n, column k) of a (rows, K) matrix in its image."""
    atom_k, unit_k = 128 // itemsize, 16 // itemsize
    block, r = divmod(n, block_rows)
    atom, kk = divmod(k, atom_k)
    unit, e = divmod(kk, unit_k)
    atom_elems = block_rows * atom_k
    return (block * (K // atom_k) + atom) * atom_elems + r * atom_k + ((unit ^ (r % 8)) * unit_k) + e


@pytest.mark.parametrize("dtype,block_rows,rows", [
    (torch.bfloat16, 32, 256), (torch.bfloat16, 32, 128), (torch.bfloat16, 64, 64),
    (torch.int8, 32, 256), (torch.int8, 64, 128),
], ids=["bf16-stage", "bf16-g1w", "bf16-tile", "int8-stage", "int8-tile"])
def test_tile_image_address_map_and_inverse(dtype, block_rows, rows):
    K = 256
    rng = np.random.default_rng(rows + block_rows)
    vals = torch.from_numpy(rng.integers(-100, 100, size=(2, rows, K)).astype(np.float32)).to(dtype)
    img = ps.tile_image(vals, block_rows)
    assert img.shape == (2, rows * K) and img.dtype == dtype and img.is_contiguous()
    want = np.empty((rows * K,), dtype=np.float32)
    src = vals[1].float().numpy()
    for n in range(rows):
        for k in range(K):
            want[image_offset(n, k, K, vals.element_size(), block_rows)] = src[n, k]
    np.testing.assert_array_equal(img[1].float().numpy(), want)
    # a 128-byte row of an atom holds one row's K-atom, units permuted
    assert torch.equal(ps.tile_image_inverse(img, rows, K, block_rows), vals)


def kblock_offset(n: int, k: int, rows: int) -> int:
    """Element offset of (row n, column k) of a (rows, K) matrix in its K-block
    image: K-block k // 32 of rows * 32 elements, row n at 32 n, the 8-element
    unit u = (k % 32) // 8 at unit u ^ ((n >> 1) % 4) (the 64-byte swizzle)."""
    block, kk = divmod(k, 32)
    unit, e = divmod(kk, 8)
    return block * rows * 32 + n * 32 + (unit ^ ((n >> 1) % 4)) * 8 + e


@pytest.mark.parametrize("rows,K", [(256, 256), (64, 96)])
def test_kblock_image_address_map_and_inverse(rows, K):
    rng = np.random.default_rng(rows + K)
    vals = torch.from_numpy(rng.integers(-100, 100, size=(2, rows, K)).astype(np.float32))
    vals = vals.to(torch.bfloat16)
    img = ps.kblock_image(vals)
    assert img.shape == (2, rows * K) and img.dtype == torch.bfloat16 and img.is_contiguous()
    want = np.empty((rows * K,), dtype=np.float32)
    src = vals[1].float().numpy()
    for n in range(rows):
        for k in range(K):
            want[kblock_offset(n, k, rows)] = src[n, k]
    np.testing.assert_array_equal(img[1].float().numpy(), want)
    assert torch.equal(ps.kblock_image_inverse(img, rows, K), vals)
    # a K-block of a 256-row matrix is one 16 KB ring stage
    assert 256 * 32 * 2 == ps.STAGE_BYTES
    with pytest.raises(ValueError):
        ps.kblock_image(vals[:, :, :48])
    with pytest.raises(ValueError):
        ps.kblock_image(vals.float())


def test_f2_kblock_entry_layout_and_round_trip():
    """``WG_IMAGE_F2K``: f2w's L layers one after another, each its 8 K-blocks
    of 16 KB, where the producer looks (``f2k + l * H * H + c * 8192``); made
    by ``with_wg_images`` beside the shared ``WG_IMAGE``, which stays as
    ``with_wg_image`` makes it for B2 and B5."""
    M, L, H = 2, 3, 256
    w = random_weights(M, L)
    both = ps.with_wg_images(w)
    f2k = both[ps.WG_IMAGE_F2K]
    assert f2k.shape == (M, L * H * H) and f2k.dtype == torch.bfloat16 and f2k.is_contiguous()
    assert torch.equal(both[ps.WG_IMAGE], cs.with_wg_image(w)[ps.WG_IMAGE])
    assert set(both) == set(w) | {ps.WG_IMAGE, ps.WG_IMAGE_F2K}
    back = ps.kblock_image_inverse(f2k.reshape(M, L, H * H), H, H)
    assert torch.equal(back, w["f2w"])
    for l, n, k in ((0, 0, 0), (2, 255, 255), (1, 100, 77), (1, 3, 40)):
        off = l * H * H + (k // 32) * (ps.STAGE_BYTES // 2) + kblock_offset(n, k % 32, H)
        assert f2k[1, off] == w["f2w"][1, l, n, k], (l, n, k)
    # one member's weights arrange to the same entry as its slice of the stack
    one = {k: v[1] for k, v in w.items()}
    assert torch.equal(ps.with_wg_images(one)[ps.WG_IMAGE_F2K], f2k[1])


def test_tile_image_refuses_ragged_shapes():
    with pytest.raises(ValueError):
        ps.tile_image(torch.zeros(48, 256, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        ps.tile_image(torch.zeros(64, 96, dtype=torch.bfloat16))


def random_weights(M, L, H=256, V=30, seed=0, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)

    def t(*shape):
        return (torch.randn(*shape, generator=g) / math.sqrt(shape[-1])).to(dtype)

    w = dict(
        table=t(M, V, H), dw0=t(M, H), db0=t(M, H), dw1=t(M, H, H), db1=t(M, H),
        c0r=t(M, H, H), c0p=t(M, H, H), c0b=t(M, H), c1w=t(M, H, H), c1b=t(M, H),
        f1w=t(M, L, H, H), f1b=t(M, L, H), f2w=t(M, L, H, H), f2b=t(M, L, H),
        l1w=t(M, L, H, H), l2w=t(M, L, H, H), l2b=t(M, L, H), ow=t(M, L, H, H), ob=t(M, L, H),
        g0h=t(M, H, H), g0e=t(M, H, H), g0b=t(M, H), g1w=t(M, H // 2, H), g1b=t(M, H // 2),
        g2w=t(M, H // 2), g2b=t(M, 1),
    )
    return {k: w[k].contiguous() for k in ps.W_ORDER}


def test_arranged_weights_layout_and_round_trip():
    M, L, H = 2, 3, 256
    w = random_weights(M, L)
    image = ps.arrange_weights(w)
    assert image.shape == (M, (13 + 10 * L) * (H * H // 2)) and image.dtype == torch.bfloat16
    back = ps.split_image(image, L)
    for k in ps.IMAGE_ORDER:
        assert torch.equal(back[k], w[k]), k
    # where the kernel's producer looks: matrix units of H*H elements in
    # IMAGE_ORDER, layers one after another, a stage 32 rows (8192 elements)
    HH, stage = H * H, ps.STAGE_COLS * H
    unit = {"dw1": 0, "c0r": 1, "c0p": 2, "c1w": 3, "f1w": 4, "f2w": 4 + L, "l1w": 4 + 2 * L,
            "l2w": 4 + 3 * L, "ow": 4 + 4 * L, "g0h": 4 + 5 * L, "g0e": 5 + 5 * L, "g1w": 6 + 5 * L}
    for name, l, n, k in (("dw1", 0, 5, 9), ("c0p", 0, 255, 255), ("f2w", 2, 100, 77),
                          ("ow", 1, 33, 200), ("g0e", 0, 64, 0), ("g1w", 0, 127, 131)):
        mat = w[name][1, l] if w[name].dim() == 4 else w[name][1]
        off = (unit[name] + l) * HH + (n // 32) * stage + image_offset(n % 32, k, H, 2, 32)
        assert image[1, off] == mat[n, k], (name, l, n, k)
    assert ps.STAGE_BYTES == stage * 2
    # one member's weights arrange to the same image as its slice of the stack
    one = {k: v[1] for k, v in w.items()}
    assert torch.equal(ps.arrange_weights(one), image[1])
    assert torch.equal(ps.with_wg_image(w)[ps.WG_IMAGE], image)


@pytest.mark.parametrize("N", [8, 16, 24])
def test_packed_row_table_matches_index_arrays(N):
    rows, cols = packed_index_arrays(N)
    table = ps.packed_row_pairs(N)
    assert table.shape == ((N // 2) * N, 2)
    assert torch.equal(table[:, 0], rows.reshape(-1))
    assert torch.equal(table[:, 1], cols.reshape(-1))
    assert int(table.max()) < N <= 255          # the kernel keeps the table in bytes


@pytest.mark.parametrize("N", [8, 16, 24])
def test_node_order_aggregation_equals_roll_sums(N):
    """The kernel's per-node statement of the symmetric aggregation against
    the plain version's roll sums: the same terms, float32 sums in another
    order."""
    g = torch.Generator().manual_seed(N)
    K, F = N // 2, 64
    w = torch.randn(K, N, F, generator=g).to(torch.bfloat16)
    xh = torch.randn(N, F, generator=g).to(torch.bfloat16)
    rolls = torch.zeros(N, F)
    for k in range(1, K + 1):
        rolls = rolls + torch.roll(w[k - 1] * xh, k, dims=0).float()
        rolls = rolls + (w[k - 1] * torch.roll(xh, -k, dims=0)).float()
    torch.testing.assert_close(ps.aggregate_by_node(w, xh), rolls, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N", [8, 16, 24])
def test_schedule_interleaves_the_filter_chain(N):
    """B1's schedule: the stages of ``stage_schedule`` over its tile pairs (the
    same length, so the same L2 bytes), each tile pair's filter chain taken as
    f1w(0), then f1w(c+1) and f2w's K-block c in turn, then K-block 7; every
    other stage where ``stage_schedule`` has it."""
    L, M, B = 7, 8, 100
    sched, plain = ps.wg_schedule(N, L), cs.stage_schedule(ps.wg_tile_pairs(N), L)
    assert len(sched) == len(plain) and sorted(sched) == sorted(plain)
    assert ps.wg_l2_weight_bytes(M, B, N, L) == M * B * len(plain) * ps.STAGE_BYTES
    assert [s for s in sched if s[0] not in ("f1w", "f2w")] == \
        [s for s in plain if s[0] not in ("f1w", "f2w")]
    chain = [("f1w", 0, 0)] + [s for c in range(8)
                               for s in ([("f1w", 0, c + 1)] if c < 7 else []) + [("f2w", 0, c)]]
    starts = [i for i, s in enumerate(sched) if s == ("f1w", 0, 0)]
    assert len(starts) == ps.wg_tile_pairs(N)
    for i in starts:
        assert sched[i:i + 16] == chain
    at = {s: i for i, s in enumerate(chain)}
    for c in range(8):
        assert at[("f1w", 0, c)] < at[("f2w", 0, c)]
    for c in range(7):
        assert at[("f1w", 0, c + 1)] < at[("f2w", 0, c)]
    # every layer's chains too
    for l in range(L):
        i = sched.index(("f1w", l, 0))
        assert sched[i:i + 16] == [(k, l, c) for k, _, c in chain]


def test_stage_schedule_of_b2_and_b5_unchanged():
    """B2's (``stage_schedule``) and B5's schedules keep f1w's eight stages
    and then f2w's eight per tile pair: only B1 interleaves them."""
    L = 2
    sched = cs.stage_schedule(1, L)
    edge_cat = ([("dw1", 0, c) for c in range(8)]
                + [(k, 0, c) for c in range(8) for k in ("c0r", "c0p")]
                + [("c1w", 0, c) for c in range(8)])
    blocks = []
    for l in range(L):
        blocks += [("l1w", l, c) for c in range(8)] + [("f1w", l, c) for c in range(8)]
        blocks += [("f2w", l, c) for c in range(8)]
        blocks += [("l2w", l, c) for c in range(8)] + [("ow", l, c) for c in range(8)]
    head = edge_cat + [(k, 0, c) for c in range(8) for k in ("g0h", "g0e")]
    assert sched == edge_cat + blocks + head + [("g1w", 0, c) for c in range(4)]
    assert cs.dense_schedule(24, 7) == cs.stage_schedule(cs.dense_tile_pairs(24), 7)
    int8 = p8.wg_schedule_int8(24, L)
    i = int8.index(("f1w", 0, 0))
    assert int8[i:i + 8] == [("f1w", 0, c) for c in range(4)] + [("f2w", 0, c) for c in range(4)]


@pytest.mark.parametrize("N,pairs", [(8, 1), (16, 1), (24, 3)])
def test_schedule_length_and_l2_bytes_by_hand(N, pairs):
    L, M, B = 7, 8, 100
    sched = ps.wg_schedule(N, L)
    # by hand, in matrices of 8 stages: edge_cat 4 (dw1, c0r, c0p, c1w) per tile
    # pair in the encoder and again in the head, the head's g0h, g0e and half a
    # g1w; per block the node products l1w, l2w, ow and f1w, f2w per tile pair
    matrices = pairs * (4 + 4 + 2.5) + L * (3 + 2 * pairs)
    assert len(sched) == int(matrices * 8)
    assert ps.wg_l2_weight_bytes(M, B, N, L) == M * B * len(sched) * 16384
    # producer and consumers walk the two operands of c0 and g0 stage by stage
    i = sched.index(("c0r", 0, 0))
    assert sched[i:i + 4] == [("c0r", 0, 0), ("c0p", 0, 0), ("c0r", 0, 1), ("c0p", 0, 1)]
    assert sched[-4:] == [("g1w", 0, c) for c in range(4)]
    assert {s[0] for s in sched} == set(ps.IMAGE_ORDER)


def test_l2_bytes_against_the_mma_sync_kernel():
    M, B, L = 8, 100, 7
    # the mma.sync kernel at N=24: 5 row tiles x 24.5 matrices + 21 node products
    assert ps.mma_sync_l2_weight_bytes(M, B, 24, L) == int(M * B * 143.5 * 256 * 256 * 2)
    # 15.05e9 bytes; 14.7 GB when a matrix is counted as 128 kB
    assert ps.mma_sync_l2_weight_bytes(M, B, 24, L) == pytest.approx(14.7e9, rel=0.03)
    assert len(ps.wg_schedule(24, L)) == 756 and len(ps.wg_schedule(16, L)) == 364
    ratio24 = ps.wg_l2_weight_bytes(M, B, 24, L) / ps.mma_sync_l2_weight_bytes(M, B, 24, L)
    ratio16 = ps.wg_l2_weight_bytes(M, B, 16, L) / ps.mma_sync_l2_weight_bytes(M, B, 16, L)
    # N=16: one tile pair for two tiles halves the 49 pair-row matrix reads; the 21 node
    # products stay: 45.5 / 70
    assert 0.65 < ratio24 < 0.67 and ratio16 == pytest.approx(0.65)


def int8_weights(M, L, seed=2):
    """Stacked int8 kernel weights from random float32 ones, as the model's
    ``kernel_weights_int8`` makes them."""
    w32 = {k: v.float() for k, v in random_weights(M, L, seed=seed).items()}
    out = {k: v.to(torch.bfloat16).contiguous() for k, v in w32.items() if k not in p8.QUANTIZED}
    scales = []
    for k in p8.SCALED:
        q, s = zip(*(p8._quant_tensor(t, per_layer=False) for t in w32[k]))
        out[k] = torch.stack(q).contiguous()
        scales.append(torch.stack(s))
    out["scales"] = torch.stack(scales, dim=1).contiguous()
    for k in ("f1w", "f2w"):
        q, s = zip(*(p8._quant_tensor(t, per_layer=True) for t in w32[k]))
        out[k], out[k + "_s"] = torch.stack(q).contiguous(), torch.stack(s).contiguous()
    return out


def test_int8_arranged_weights_layout_and_round_trip():
    M, L, H = 2, 3, 256
    w = int8_weights(M, L)
    image8, image = p8.arrange_weights_int8(w)
    assert image8.dtype == torch.int8 and image8.shape == (M, (13 + 4 * L) * (H * H // 2))
    assert image.dtype == torch.bfloat16 and image.shape == (M, 3 * L * H * H)
    back = p8.split_images_int8(image8, image, L)
    for k in (*p8.IMAGE8_ORDER, *p8.NODE_IMAGE_ORDER):
        assert torch.equal(back[k], w[k]), k
    # an int8 stage is 64 output columns: two 32-row blocks of 8 KB
    HH = H * H
    unit8 = {"dw1": 0, "c0r": 1, "c0p": 2, "c1w": 3, "f1w": 4, "f2w": 4 + L, "g0h": 4 + 2 * L,
             "g0e": 5 + 2 * L, "g1w": 6 + 2 * L}
    for name, l, n, k in (("dw1", 0, 5, 9), ("c0p", 0, 255, 255), ("f2w", 2, 100, 77),
                          ("g0e", 0, 64, 130), ("g1w", 0, 127, 131)):
        mat = w[name][1, l] if w[name].dim() == 4 else w[name][1]
        off = (unit8[name] + l) * HH + (n // 32) * 32 * H + image_offset(n % 32, k, H, 1, 32)
        assert image8[1, off] == mat[n, k], (name, l, n, k)
    for name, u, l, n, k in (("l1w", 0, 1, 40, 200), ("ow", 2 * L, 2, 255, 3)):
        off = (u + l) * HH + (n // 32) * 32 * H + image_offset(n % 32, k, H, 2, 32)
        assert image[1, off] == w[name][1, l, n, k]
    both = p8.with_wg_images_int8(w)
    assert torch.equal(both[p8.WG_IMAGE8], image8) and torch.equal(both[ps.WG_IMAGE], image)
    # cast_unquantized keeps the codes' image as it is
    assert p8.cast_unquantized(both, torch.float32)[p8.WG_IMAGE8].dtype == torch.int8


@pytest.mark.parametrize("N,pairs", [(16, 1), (24, 3)])
def test_int8_schedule_and_l2_bytes_by_hand(N, pairs):
    L, M, B = 7, 8, 100
    sched = p8.wg_schedule_int8(N, L)
    # int8 matrices in 4 stages of 64 columns, node matrices (bf16) in 8 of 32
    stages = pairs * 4 * (4 + 4 + 2.5) + L * (3 * 8 + 2 * 4 * pairs)
    assert len(sched) == int(stages)
    assert p8.wg_l2_weight_bytes_int8(M, B, N, L) == M * B * len(sched) * 16384
    tiles = 2 * pairs if N == 16 else 5
    assert p8.mma_sync_l2_weight_bytes_int8(M, B, N, L) == \
        M * B * 65536 * (tiles * 24.5 + 2 * 21)
    assert p8.wg_l2_weight_bytes_int8(M, B, N, L) < p8.mma_sync_l2_weight_bytes_int8(M, B, N, L)


def cpu_inputs(M, B, N, H, seed):
    g = torch.Generator().manual_seed(seed)
    K = N // 2
    z = torch.randn(M, B, N, H, generator=g).to(torch.bfloat16)
    d = 0.8 + 4 * torch.rand(B, K, N, generator=g)
    cmask = (torch.rand(B, K, N, generator=g) < 0.8).float()
    types = [torch.randint(0, 26, (B, K, N), generator=g, dtype=torch.int32) for _ in range(4)]
    return z, d, cmask, types


def test_cpu_tensors_take_the_plain_version_with_arranged_entries():
    M, B, N, L = 1, 2, 8, 1
    w = ps.with_wg_images(random_weights(M, L))
    z, d, cmask, types = cpu_inputs(M, B, N, 256, seed=1)
    calls, launches = ps.packed_score_reference.calls, ps.packed_score.launches
    out = ps.packed_score(w, z, d, cmask, *types, num_blocks=L)
    assert ps.packed_score_reference.calls == calls + 1
    assert (ps.packed_score.launches, ps.packed_score.wg_launches) == (launches, ps.packed_score.wg_launches)
    bare = {k: v for k, v in w.items() if k not in (ps.WG_IMAGE, ps.WG_IMAGE_F2K)}
    # the same function of the same inputs; a CPU matrix product may split its
    # float32 sums differently from call to call, and a bf16 rounding then flips
    ref = ps.packed_score_reference(bare, z, d, cmask, *types, num_blocks=L)
    assert out.shape == ref.shape == (M, B, N // 2, N)
    torch.testing.assert_close(out, ref, rtol=0, atol=3e-2 * ref.abs().max().item())
    # the bound reads the same work with and without the arranged copy
    assert ps.packed_score_cost(w, z, L) == ps.packed_score_cost(bare, z, L)


def test_int8_cpu_tensors_take_the_plain_version_with_arranged_entries():
    M, B, N, L = 1, 2, 8, 1
    w = int8_weights(M, L)
    z, d, cmask, types = cpu_inputs(M, B, N, 256, seed=3)
    ref = p8.packed_score_int8_reference(w, z, d, cmask, *types, num_blocks=L)
    calls, launches = p8.packed_score_int8_reference.calls, p8.packed_score_int8.launches
    out = p8.packed_score_int8(p8.with_wg_images_int8(w), z, d, cmask, *types, num_blocks=L)
    assert p8.packed_score_int8_reference.calls == calls + 1
    assert p8.packed_score_int8.launches == launches
    torch.testing.assert_close(out, ref, rtol=0, atol=6e-2 * ref.abs().max().item())
    assert p8.packed_score_int8_cost(p8.with_wg_images_int8(w), z, L) == \
        p8.packed_score_int8_cost(w, z, L)


def test_model_kernel_weights_carry_the_image_in_bf16_only():
    """``kernel_weights()`` of the production model (H=256) adds the arranged
    entries in bfloat16, where a kernel takes them, and not in float32; B1's
    own ``WG_IMAGE_F2K`` is in neither B2's (``fused_weights``) nor B5's
    (``kernel_weights_int8``) dictionary, nor at H=128."""
    import os

    from tsdiff_tpu_torch.config import Config
    from tsdiff_tpu_torch.models import CondenseEncoderEpsNetwork
    from tsdiff_tpu_torch.train import load_checkpoint

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ck = load_checkpoint(os.path.join(repo, "artifacts", "seeds", "ckpts", "seed106_best.ckpt"))
    cfg = Config(ck["config"]["model"])
    w = CondenseEncoderEpsNetwork.from_config(cfg, dtype=torch.bfloat16).kernel_weights()
    assert torch.equal(w[ps.WG_IMAGE], ps.arrange_weights({k: w[k] for k in ps.IMAGE_ORDER}))
    assert torch.equal(w[ps.WG_IMAGE_F2K], ps.arrange_f2_kblocks(w["f2w"]))
    assert set(w) == set(ps.W_ORDER) | {ps.WG_IMAGE, ps.WG_IMAGE_F2K}
    model32 = CondenseEncoderEpsNetwork.from_config(cfg, dtype=torch.float32)
    assert set(model32.kernel_weights()) == set(ps.W_ORDER)
    w8 = CondenseEncoderEpsNetwork.from_config(cfg, dtype=torch.bfloat16).kernel_weights_int8()
    image8, image = p8.arrange_weights_int8(w8)
    assert torch.equal(w8[p8.WG_IMAGE8], image8) and torch.equal(w8[ps.WG_IMAGE], image)
    assert p8.WG_IMAGE8 not in model32.kernel_weights_int8()
    assert ps.WG_IMAGE_F2K not in w8
    fused = CondenseEncoderEpsNetwork.from_config(Config({**ck["config"]["model"],
                                                          "fused_score": True}),
                                                  dtype=torch.bfloat16).fused_weights()
    assert ps.WG_IMAGE in fused and ps.WG_IMAGE_F2K not in fused
    narrow = {**ck["config"]["model"], "hidden_dim": 128,
              "encoder": {**ck["config"]["model"]["encoder"], "hidden_dim": 128}}
    w128 = CondenseEncoderEpsNetwork.from_config(Config(narrow), dtype=torch.bfloat16).kernel_weights()
    assert w128["f2w"].shape[-1] == 128 and set(w128) == set(ps.W_ORDER)
