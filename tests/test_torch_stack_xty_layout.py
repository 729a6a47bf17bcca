"""The host side of the ``wgmma`` weight-gradient kernel of B3's backward
(``csrc/schnet_stack.cu::schnet_bwd_xty_wg_kernel``), on the CPU: the 2-D
tensor copy's 128-byte swizzle of a 64 x 64 bf16 box, emulated in numpy; the
addresses its MN-major descriptors (imm-trans = 1) read for each k16 step; the
schedule of stage-units over the CTAs and the fixed order in which the
partials are summed; the constants against the sources; and the wrapper's
choice of the plain version for CPU tensors."""

import os
import re

import numpy as np
import pytest
import torch

from tsdiff_tpu_torch.ops import packed_score as ps
from tsdiff_tpu_torch.ops import schnet_stack as ss

CSRC = os.path.join(os.path.dirname(ss.__file__), os.pardir, "csrc")
H = 256
BOX = 64          # a box is 64 columns (128 bytes of bf16) by 64 rows
SMS = 132         # the H100 SXM's SMs: one CTA each


def source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def constant(text: str, name: str) -> int:
    return int(re.search(rf"constexpr \w+ {name} = (\d+);", text).group(1))


def test_constants_match_the_sources():
    """``XTY_*`` are the kernel's numbers, and ``XTY_JOBS`` its order of X and
    Y in ``launch_bwd``."""
    header, stack = source("wg_pipeline.cuh"), source("schnet_stack.cu")
    assert constant(header, "kMnBoxRows") == ss.XTY_STAGE_ROWS == BOX
    assert constant(header, "kMnBoxBytes") == ss.XTY_BOX_BYTES == BOX * 128
    assert constant(header, "kMnGroupBytes") == ss.XTY_GROUP_BYTES == 8 * 128
    assert constant(header, "kMnK16Bytes") == ss.XTY_K16_BYTES == 16 * 128
    assert constant(stack, "kXtyWgTileM") == ss.XTY_TILE_M
    assert constant(stack, "kJobs") == len(ss.XTY_JOBS)
    for side, col in (("xs", 1), ("ys", 2)):
        names = re.search(rf"const T\* {side}\[kJobs\] = \{{([^}}]*)\}};", stack).group(1)
        assert [n.strip()[2:] for n in names.split(",")] == [j[col] for j in ss.XTY_JOBS], side
    # the descriptor's fields and the instruction's transpose flags
    assert "d |= (uint64_t)(kMnBoxBytes >> 4) << 16;" in header
    assert "d |= (uint64_t)(kMnGroupBytes >> 4) << 32;" in header
    assert "m64n256k16.f32.bf16.bf16" in header and "p, 1, 1, 1, 1;" in header


def tma_box(mat: np.ndarray, row0: int, col0: int) -> np.ndarray:
    """The 2-D tensor copy of ``mat``'s box at (row0, col0) with the 128-byte
    swizzle, as bf16 elements by shared-memory address / 2: row r at byte
    128 r, its 16-byte unit u at unit u ^ (r % 8); rows past the end zero."""
    rows = mat.shape[0]
    out = np.zeros(BOX * BOX, dtype=mat.dtype)
    for r in range(BOX):
        if row0 + r >= rows:
            continue
        for u in range(8):
            dst = (r * 128 + ((u ^ (r % 8)) << 4)) // 2
            out[dst:dst + 8] = mat[row0 + r, col0 + 8 * u:col0 + 8 * u + 8]
    return out


def mn_major_address(start: int, mn: np.ndarray, k: np.ndarray) -> np.ndarray:
    """The byte address wgmma reads for element (mn, k) of an MN-major
    operand with the 128-byte swizzle: the canonical layout ((8 elements, 8
    units, boxes), (8 rows, groups)) with strides ((2 bytes, 16, the leading
    byte offset), (128, the stride byte offset)), then bits 4-6 XOR bits 7-9."""
    off = (start + (mn // 64) * ss.XTY_BOX_BYTES + (mn % 64) * 2
           + (k // 8) * ss.XTY_GROUP_BYTES + (k % 8) * 128)
    return off ^ (((off >> 7) & 7) << 4)


def stage_image(x: np.ndarray, y: np.ndarray, mt: int, row0: int) -> np.ndarray:
    """One ring stage as the producer fills it: X's boxes at columns 128 mt
    and 128 mt + 64 (warpgroups 0, 1), then Y's four boxes."""
    boxes = [tma_box(x, row0, ss.XTY_TILE_M * mt + 64 * w) for w in range(2)]
    boxes += [tma_box(y, row0, 64 * q) for q in range(4)]
    return np.concatenate(boxes)


@pytest.mark.parametrize("col0", [0, 64, 128, 192])
def test_tma_box_is_the_tile_image(col0):
    """The copy's swizzle is the tile image's (``packed_score.tile_image``,
    the layout of the 1-D bulk copies the other kernels run on the card)."""
    rng = np.random.default_rng(col0)
    mat = rng.integers(-1000, 1000, size=(192, H)).astype(np.int16)
    for row0 in (0, 64, 128):
        img = ps.tile_image(torch.from_numpy(mat[row0:row0 + BOX, col0:col0 + BOX].copy()), BOX)
        assert np.array_equal(tma_box(mat, row0, col0), img.numpy())


@pytest.mark.parametrize("mt", [0, 1])
@pytest.mark.parametrize("ks", [0, 1, 2, 3])
def test_mn_major_descriptors_pick_the_transposed_operands(mt, ks):
    """k16 step ``ks`` of a stage: warpgroup w's A descriptor (its X box,
    advanced by ``ks * XTY_K16_BYTES``) reads X[k0 + k, 128 mt + 64 w + m] as
    A[m, k], and the B descriptor (Y's four boxes) reads Y[k0 + k, n] as
    B[k, n], k0 = row0 + 16 ks: X^T Y over the stage's rows."""
    rng = np.random.default_rng(10 * mt + ks)
    rows, row0 = 256, 128
    x = rng.integers(-1000, 1000, size=(rows, H)).astype(np.int16)
    y = rng.integers(-1000, 1000, size=(rows, H)).astype(np.int16)
    smem = stage_image(x, y, mt, row0)
    k0 = row0 + 16 * ks
    m, k = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
    for w in range(2):
        a = smem[mn_major_address(w * ss.XTY_BOX_BYTES + ks * ss.XTY_K16_BYTES, m, k) // 2]
        assert np.array_equal(a, x[k0:k0 + 16, ss.XTY_TILE_M * mt + 64 * w:][:, :64].T)
    n, kb = np.meshgrid(np.arange(H), np.arange(16), indexing="ij")
    b = smem[mn_major_address(2 * ss.XTY_BOX_BYTES + ks * ss.XTY_K16_BYTES, n, kb) // 2]
    assert np.array_equal(b.T, y[k0:k0 + 16])


def test_emulated_stage_product_with_a_partial_slab():
    """A whole product through the emulated copies and descriptors, the last
    stage past the tensor's end (its rows zero): equal to X^T Y exactly on
    integer inputs."""
    rng = np.random.default_rng(7)
    rows = 150                      # three stages, the last with 22 rows
    x = rng.integers(-3, 4, size=(rows, H)).astype(np.int64)
    y = rng.integers(-3, 4, size=(rows, H)).astype(np.int64)
    out = np.zeros((H, H), dtype=np.int64)
    m, k = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
    n, kb = np.meshgrid(np.arange(H), np.arange(16), indexing="ij")
    for mt in range(2):
        for s in range(-(-rows // BOX)):
            smem = stage_image(x, y, mt, BOX * s)
            for ks in range(4):
                b = smem[mn_major_address(2 * ss.XTY_BOX_BYTES + ks * ss.XTY_K16_BYTES, n, kb)
                         // 2].T
                for w in range(2):
                    a = smem[mn_major_address(w * ss.XTY_BOX_BYTES + ks * ss.XTY_K16_BYTES, m, k)
                             // 2]
                    r0 = ss.XTY_TILE_M * mt + 64 * w
                    out[r0:r0 + 64] += a @ b
    assert np.array_equal(out, x.T @ y)


def schedule(B, N):
    return ss.xty_schedule(B * N * N, B * N, SMS)


@pytest.mark.parametrize("N", [8, 16, 24])
@pytest.mark.parametrize("B", [1, 3, 200])
def test_xty_schedule_covers_every_row_once(B, N):
    """Every stage of every (job, M-tile) in exactly one segment, in order;
    segments start on multiples of 64 rows; each CTA gets the same number of
    stages within one, at most one CTA per stage; the partials of an output
    are consecutive segments (summed in that order); the table is what the
    kernel reads."""
    sched = schedule(B, N)
    segs, cb, ob = sched["segments"], sched["cta_begin"], sched["out_begin"]
    stages = [-(-r // BOX) for r in (B * N * N,) * 2 + (B * N,) * 3]
    total = 2 * sum(stages)
    assert sched["ctas"] == min(SMS, total) and len(cb) == sched["ctas"] + 1
    assert cb[0] == 0 and cb[-1] == len(segs) and all(a < b for a, b in zip(cb, cb[1:]))
    per_cta = [sum(s1 - s0 for _, _, s0, s1 in segs[a:b]) for a, b in zip(cb, cb[1:])]
    assert sum(per_cta) == total and max(per_cta) - min(per_cta) <= 1
    assert len(segs) <= sched["ctas"] + 9
    for o in range(10):
        mine = segs[ob[o]:ob[o + 1]]
        assert all(2 * j + mt == o for j, mt, _, _ in mine)
        bounds = [s0 for _, _, s0, _ in mine] + [mine[-1][3]]
        assert bounds[0] == 0 and bounds[-1] == stages[o // 2]
        assert all(a < b for a, b in zip(bounds, bounds[1:]))
        assert all(segs[i][3] == segs[i + 1][2] for i in range(ob[o], ob[o + 1] - 1))
    assert ob[-1] == len(segs)
    table = ss.xty_schedule_table(sched)
    assert table[:len(cb)] == cb and table[len(cb):len(cb) + 11] == ob
    assert table[len(cb) + 11:] == [v for sg in segs for v in sg]
    assert max(table) < 2 ** 31


@pytest.mark.parametrize("N", [8, 16, 24])
@pytest.mark.parametrize("B", [1, 3, 200])
def test_xty_schedule_sum_is_the_plain_products(B, N):
    """Each segment's partial (its rows of X's M-tile columns, transposed,
    times its rows of Y, in float32), added in segment order per output: on
    small integer-valued bf16 inputs, where every float32 sum is exact, equal
    bit for bit to ``_xty``."""
    g = torch.Generator().manual_seed(B * 100 + N)
    rows = (B * N * N,) * 2 + (B * N,) * 3
    xs = [torch.randint(-3, 4, (r, H), generator=g).to(torch.bfloat16) for r in rows]
    ys = [torch.randint(-3, 4, (r, H), generator=g).to(torch.bfloat16) for r in rows]
    sched = schedule(B, N)
    segs, ob = sched["segments"], sched["out_begin"]
    for job in range(5):
        got = torch.empty((H, H))
        for mt in range(2):
            o = 2 * job + mt
            acc = torch.zeros((ss.XTY_TILE_M, H))
            for _, _, s0, s1 in segs[ob[o]:ob[o + 1]]:
                r = slice(BOX * s0, min(BOX * s1, rows[job]))
                cols = slice(ss.XTY_TILE_M * mt, ss.XTY_TILE_M * (mt + 1))
                acc += xs[job][r, cols].float().t() @ ys[job][r].float()
            got[ss.XTY_TILE_M * mt:ss.XTY_TILE_M * (mt + 1)] = acc
        assert torch.equal(got, ss._xty(xs[job], ys[job])), job


def test_cpu_xty_takes_the_plain_version(monkeypatch):
    """On CPU tensors ``schnet_stack_xty`` is the plain version and never
    loads the kernel library; the plain backward's collected operands give
    its weight gradients bit for bit, block by block."""
    def no_library():
        raise AssertionError("the kernel library was loaded for CPU tensors")

    monkeypatch.setattr(ss, "_kernel_lib", no_library)
    B, N, Hs, L = 2, 8, 32, 2
    g = torch.Generator().manual_seed(3)
    w = {k: (torch.randn((L, Hs, Hs) if k in ("f1w", "f2w", "l1w", "l2w", "ow") else (L, Hs),
                         generator=g) / 4).to(torch.bfloat16) for k in ss.W_KEYS}
    h = torch.randn(B, N, Hs, generator=g).to(torch.bfloat16)
    ea = torch.randn(B, N * N, Hs, generator=g).to(torch.bfloat16)
    c = (torch.rand(B, N * N, generator=g) < 0.6).to(torch.bfloat16)
    cot = torch.randn(B, N, Hs, generator=g).to(torch.bfloat16)
    _, hs = ss.schnet_stack_fwd_reference(w, h, ea, c)
    operands = []
    _, _, grads = ss.schnet_stack_bwd_reference(w, ea, c, hs, cot, operands=operands)
    assert len(operands) == L
    calls = ss.xty_reference.calls
    launches = (ss.schnet_stack_xty.launches, ss.schnet_stack_xty.wg_launches)
    for l, (xs, ys) in zip(reversed(range(L)), operands):
        assert [tuple(t.shape) for t in xs + ys] == [(B * N * N, Hs)] * 2 + [(B * N, Hs)] * 3 \
            + [(B * N * N, Hs)] * 2 + [(B * N, Hs)] * 3
        assert all(t.is_contiguous() and t.dtype == torch.bfloat16 for t in xs + ys)
        out = ss.schnet_stack_xty(xs, ys)
        for k, (name, _, _) in enumerate(ss.XTY_JOBS):
            assert torch.equal(out[k], grads[name][l]), (l, name)
    assert ss.xty_reference.calls == calls + L
    assert (ss.schnet_stack_xty.launches, ss.schnet_stack_xty.wg_launches) == launches
