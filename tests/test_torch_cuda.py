"""The CUDA kernels against their plain PyTorch versions, on the card: the
packed score step (B1) and its int8 variant (B5): for each the warp-specialised wgmma kernel
in bfloat16, the mma.sync kernel in float32 and the tile product of the
former alone; the dense score step (B2): its warp-specialised wgmma kernel in
bfloat16 and its mma.sync kernel in float32; and the fused SchNet stack
(B3's forward and backward, B4; the forward's wgmma kernel and the
backward's wgmma row and weight-gradient kernels in bfloat16, their mma.sync
ones in float32; the weight-gradient kernel also alone, against the plain
products and against ``torch.mm``).  The serving walk
(``tsdiff_tpu_torch/serve.py``, ``diffusion/captured.py``) with the 8 trained
campaign members of ``artifacts/seeds/ckpts``: a round replayed from its CUDA
graph equals the eager round on the same seed bit for bit, through B1 in
bfloat16 and B5, at tiers 4 and 32 (N=24) and for the dense ensemble; a
second round of a (bucket, tier, respacing) records no graph; and a
captured round launches the score kernel once per walk step, counted under
torch.profiler (the wrappers' counters advance only when a graph is recorded);
a round traced by the benchmark's tracer shows the program's spans on the
kernels' clock, and none of them as a kernel.
The sampling CLI from two trained members written as reference ``.pt``
files gives the samples it gives from their ``.ckpt`` files, bit for bit.
The train step replayed from its CUDA graph (``train/captured.py``, B3's
kernels inside it with ``use_pallas``, or the ``packed_train`` objective),
stepped in lockstep with two eager runs for 10 steps on the same draws,
each step from the eager run's state, equals the eager step bit for bit on
every step in every tensor and metric that the one nondeterministic op of
the step (F.embedding's backward into the bond-type table, which two eager
runs also disagree on) does not feed; a learning
rate changed between replays takes effect; graphs of two buckets in one
memory pool replayed in alternation give what each gives alone.

Every test here needs an NVIDIA GPU with nvcc (marker ``cuda``) and skips
without one.  The file imports neither JAX nor the JAX package, so on a
machine without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -s

Tolerances, as a fraction of the output's largest magnitude: float32 1e-4
(the kernel and the plain version do the same operations; only the order of
the float32 sums differs); bfloat16 3e-2 at the worst element and 3e-3 on
average (both round to bf16 at the same points, but a different float32 sum
order can flip a rounding by one bf16 ulp, 2^-8 relative, and such flips
propagate through the L blocks).  The stack's outputs, its backward's
gradients included, are held to the same tolerances.  The int8 kernel's
int32 sums are exact in the kernel and in the plain version, but an activation
that a reordered float32 sum moves by one ulp across a rounding tie of its
row's quantization flips that int8 code by one, 1/127 of the row's maximum,
two bf16 ulps of it.  So in bfloat16 the int8 kernel is held to twice the
bfloat16 tolerance; in float32 a flipped code is far above the float32
tolerance, and the int8 kernel is held to 1e-2 at the worst element and 1e-3 on
average: a handful of flipped codes among the ~1e5 of a call (``TOL_INT8``).
"""

import math
import os

import numpy as np
import pytest
import torch

from tsdiff_tpu_torch.ops import condensed_score as cs
from tsdiff_tpu_torch.ops import packed_score as ps
from tsdiff_tpu_torch.ops import packed_score_int8 as p8
from tsdiff_tpu_torch.ops import schnet_stack as ss

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 3e-3)}
TOL_INT8 = {torch.float32: (1e-2, 1e-3), torch.bfloat16: (6e-2, 6e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def random_inputs(M, B, N, H, L, dtype, device, seed=0, V=100):
    g = torch.Generator().manual_seed(seed)
    K = N // 2

    def mat(*shape):
        return torch.randn(*shape, generator=g) / math.sqrt(shape[-1])

    def vec(*shape):
        return 0.1 * torch.randn(*shape, generator=g)

    w = dict(
        table=torch.randn(M, V, H, generator=g), dw0=torch.randn(M, H, generator=g),
        db0=vec(M, H), dw1=mat(M, H, H), db1=vec(M, H),
        c0r=mat(M, H, H), c0p=mat(M, H, H), c0b=vec(M, H), c1w=mat(M, H, H), c1b=vec(M, H),
        f1w=mat(M, L, H, H), f1b=vec(M, L, H), f2w=mat(M, L, H, H), f2b=vec(M, L, H),
        l1w=mat(M, L, H, H), l2w=mat(M, L, H, H) / N, l2b=vec(M, L, H),
        ow=mat(M, L, H, H), ob=vec(M, L, H),
        g0h=mat(M, H, H), g0e=mat(M, H, H), g0b=vec(M, H),
        g1w=mat(M, H // 2, H), g1b=vec(M, H // 2), g2w=mat(M, H // 2), g2b=vec(M, 1),
    )
    w = {k: w[k].to(device=device, dtype=dtype).contiguous() for k in ps.W_ORDER}
    if dtype == torch.bfloat16 and H == 256:
        w = ps.with_wg_images(w)    # what the model's kernel_weights() adds
    z = torch.randn(M, B, N, H, generator=g).to(device=device, dtype=dtype)
    d = (0.8 + 4 * torch.rand(B, K, N, generator=g)).to(device)
    cmask = (torch.rand(B, K, N, generator=g) < 0.8).float()
    cmask[:, -1] *= 0.5
    types = [torch.randint(0, 26, (B, K, N), generator=g, dtype=torch.int32).to(device)
             for _ in range(4)]
    return w, z, d, cmask.to(device), types


@pytest.mark.cuda
def test_tile_product_selftest(cuda):
    """The warp-specialised kernels' tile product alone: 64 x 256 by the
    arranged 256 x 256 weight through the shared-memory ring, A from shared
    memory and from registers, and full width from the weight's K-blocks in
    the 64-byte swizzle (B1's filter chain), against a float32 matrix product
    (an oracle here, never a call of the port).  bf16 products are exact in
    float32; only the order of the 256-term float32 sums differs."""
    g = torch.Generator().manual_seed(3)
    a = torch.randn(64, 256, generator=g).to(cuda, torch.bfloat16)
    w = (torch.randn(256, 256, generator=g) / 16).to(cuda, torch.bfloat16)
    out = ps.tile_product_selftest(a, w)
    torch.cuda.synchronize()
    ref = a.float() @ w.float().T
    assert out.shape == (3, 64, 256)
    for i, name in enumerate(("A from shared memory", "A from registers",
                              "full width from K-blocks")):
        err = (out[i] - ref).abs().max().item()
        print(f"tile product, {name}: max err {err:.3g} of {ref.abs().max().item():.3g}")
        assert err <= 1e-4 * ref.abs().max().item(), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("N", [8, 16, 24])
def test_kernel_matches_reference(cuda, dtype, N):
    M, B, H, L = 2, 3, 256, 2
    w, z, d, cmask, types = random_inputs(M, B, N, H, L, dtype, cuda, seed=N)
    launches, wg_launches = ps.packed_score.launches, ps.packed_score.wg_launches
    out = ps.packed_score(w, z, d, cmask, *types, num_blocks=L)
    torch.cuda.synchronize()
    assert ps.packed_score.launches == launches + 1
    # bf16 takes the warp-specialised kernel, f32 the mma.sync kernel
    assert ps.packed_score.wg_launches == wg_launches + int(dtype == torch.bfloat16)
    ref = ps.packed_score_reference(w, z, d, cmask, *types, num_blocks=L)
    scale = ref.abs().max().item()
    err = (out - ref).abs()
    print(f"N={N} {dtype}: max|ref| {scale:.4g} max err {err.max().item():.3g} "
          f"mean err {err.mean().item():.3g}")
    tol_max, tol_mean = TOL[dtype]
    assert torch.isfinite(out).all()
    assert err.max().item() <= tol_max * scale
    assert err.mean().item() <= tol_mean * scale


@pytest.mark.cuda
@pytest.mark.parametrize("N", [8, 16, 24])
@pytest.mark.parametrize("M,B", [(1, 3), (2, 4), (1, 1), (8, 100), (8, 4), (4, 100)],
                         ids=["M1-B3", "M2-B4", "M1-B1", "M8-B100", "M8-B4", "M4-B100"])
def test_wg_kernel_shapes_zero_mask_and_repeat(cuda, M, B, N):
    """The warp-specialised bf16 kernel at one and two members, odd and even
    graph counts, the campaign's M=8, B=100, a served tier (B=4) and the
    mesh's four members a rank, with a whole offset slab of ``cmask`` zero
    (those rows add nothing to the aggregation): against the plain version,
    and two launches bitwise equal (no atomics, fixed summation order)."""
    H, L = 256, 3
    w, z, d, cmask, types = random_inputs(M, B, N, H, L, torch.bfloat16, cuda, seed=7 * N + B)
    cmask[:, N // 4] = 0.0
    cmask[0] = 0.0                      # graph 0: no edge at all
    before = ps.packed_score.wg_launches
    out = ps.packed_score(w, z, d, cmask, *types, num_blocks=L)
    again = ps.packed_score(w, z, d, cmask, *types, num_blocks=L)
    torch.cuda.synchronize()
    assert ps.packed_score.wg_launches == before + 2
    assert torch.equal(out, again)
    ref = ps.packed_score_reference(w, z, d, cmask, *types, num_blocks=L)
    assert_close(f"wg M={M} B={B} N={N}", out, ref, torch.bfloat16)


@pytest.mark.cuda
def test_wg_kernel_needs_the_arranged_weights(cuda):
    """Without ``weights[WG_IMAGE]`` or ``weights[WG_IMAGE_F2K]`` the bf16
    H=256 shape raises: it does not give way to the mma.sync kernel or to the
    plain version."""
    w, z, d, cmask, types = random_inputs(1, 2, 8, 256, 1, torch.bfloat16, cuda)
    calls, launches = ps.packed_score_reference.calls, ps.packed_score.launches
    for key in (ps.WG_IMAGE, ps.WG_IMAGE_F2K):
        bare = {k: v for k, v in w.items() if k != key}
        with pytest.raises(ValueError):
            ps.packed_score(bare, z, d, cmask, *types, num_blocks=1)
    assert (ps.packed_score_reference.calls, ps.packed_score.launches) == (calls, launches)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [8, 16, 24])
@pytest.mark.parametrize("M,B", [(1, 3), (2, 4), (1, 1)], ids=["M1-B3", "M2-B4", "M1-B1"])
def test_int8_wg_kernel_shapes_zero_mask_and_repeat(cuda, M, B, N):
    """The warp-specialised int8 kernel as ``test_wg_kernel_shapes_zero_mask_and_repeat``."""
    H, L = 256, 3
    w32, z, d, cmask, types = random_inputs(M, B, N, H, L, torch.float32, cuda, seed=7 * N + B)
    w, zb = quantized(w32, torch.bfloat16), z.to(torch.bfloat16)
    cmask[:, N // 4] = 0.0
    cmask[0] = 0.0
    before = p8.packed_score_int8.wg_launches
    out = p8.packed_score_int8(w, zb, d, cmask, *types, num_blocks=L)
    again = p8.packed_score_int8(w, zb, d, cmask, *types, num_blocks=L)
    torch.cuda.synchronize()
    assert p8.packed_score_int8.wg_launches == before + 2
    assert torch.equal(out, again)
    ref = p8.packed_score_int8_reference(w, zb, d, cmask, *types, num_blocks=L)
    assert_close(f"int8 wg M={M} B={B} N={N}", out, ref, torch.bfloat16, tol=TOL_INT8[torch.bfloat16])


@pytest.mark.cuda
def test_int8_wg_kernel_needs_the_arranged_weights(cuda):
    w32, z, d, cmask, types = random_inputs(1, 2, 8, 256, 1, torch.float32, cuda)
    w = quantized(w32, torch.bfloat16)
    bare = {k: v for k, v in w.items() if k != p8.WG_IMAGE8}
    calls, launches = p8.packed_score_int8_reference.calls, p8.packed_score_int8.launches
    with pytest.raises(ValueError):
        p8.packed_score_int8(bare, z.to(torch.bfloat16), d, cmask, *types, num_blocks=1)
    assert (p8.packed_score_int8_reference.calls, p8.packed_score_int8.launches) == (calls, launches)


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_path(cuda):
    """A CUDA tensor launches the kernel or raises; it never falls back."""
    w, z, d, cmask, types = random_inputs(1, 2, 8, 256, 1, torch.bfloat16, cuda)
    calls, launches = ps.packed_score_reference.calls, ps.packed_score.launches
    ps.packed_score(w, z, d, cmask, *types, num_blocks=1)
    assert ps.packed_score.launches == launches + 1
    assert ps.packed_score_reference.calls == calls
    # a shape the kernel does not take raises instead of falling back
    w2, z2, d2, c2, t2 = random_inputs(1, 2, 8, 32, 1, torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        ps.packed_score(w2, z2, d2, c2, *t2, num_blocks=1)
    assert ps.packed_score_reference.calls == calls


def quantized(w32: dict, dtype) -> dict:
    """Stacked (M, ...) float32 kernel weights -> the int8 op's weights: per
    member and tensor (per layer for f1w, f2w) codes and scales, the rest in
    ``dtype``."""
    out = {k: v.to(dtype).contiguous() for k, v in w32.items() if k not in p8.QUANTIZED}
    scales = []
    for k in p8.SCALED:
        q, s = zip(*(p8._quant_tensor(t, per_layer=False) for t in w32[k]))
        out[k] = torch.stack(q).contiguous()
        scales.append(torch.stack(s))
    out["scales"] = torch.stack(scales, dim=1).contiguous()            # (M, 8)
    for k in ("f1w", "f2w"):
        q, s = zip(*(p8._quant_tensor(t, per_layer=True) for t in w32[k]))
        out[k], out[k + "_s"] = torch.stack(q).contiguous(), torch.stack(s).contiguous()
    if dtype == torch.bfloat16 and out["dw1"].shape[-1] == 256:
        out = p8.with_wg_images_int8(out)    # what the model's kernel_weights_int8() adds
    return out


@pytest.mark.cuda
def test_int8_tile_product_selftest(cuda):
    """The int8 tile product alone: 64 x 256 codes by the arranged 256 x 256
    codes through the ring, against an integer matrix product: exact."""
    g = torch.Generator().manual_seed(4)
    a = torch.randint(-127, 128, (64, 256), generator=g, dtype=torch.int8).to(cuda)
    w = torch.randint(-127, 128, (256, 256), generator=g, dtype=torch.int8).to(cuda)
    out = p8.tile_product_selftest_int8(a, w)
    torch.cuda.synchronize()
    ref = (a.double() @ w.double().T).to(torch.int32)
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("N", [8, 16, 24])
def test_int8_kernel_matches_reference(cuda, dtype, N):
    M, B, H, L = 2, 3, 256, 2
    w32, z, d, cmask, types = random_inputs(M, B, N, H, L, torch.float32, cuda, seed=N)
    w = quantized(w32, dtype)
    z = z.to(dtype)
    launches = p8.packed_score_int8.launches, ps.packed_score.launches
    wg_before = p8.packed_score_int8.wg_launches
    out = p8.packed_score_int8(w, z, d, cmask, *types, num_blocks=L)
    torch.cuda.synchronize()
    assert p8.packed_score_int8.launches == launches[0] + 1
    assert ps.packed_score.launches == launches[1]
    assert p8.packed_score_int8.wg_launches == wg_before + int(dtype == torch.bfloat16)
    ref = p8.packed_score_int8_reference(w, z, d, cmask, *types, num_blocks=L)
    assert_close(f"int8 N={N}", out, ref, dtype, tol=TOL_INT8[dtype])
    # quantization changes the numbers, by a few percent on these random weights
    full = ps.packed_score_reference({k: v.to(dtype) for k, v in w32.items()}, z, d, cmask,
                                     *types, num_blocks=L)
    rel = ((out - full).norm() / full.norm()).item()
    print(f"int8 N={N} {dtype}: relative L2 to the unquantized plain version {rel:.3g}")
    assert 0 < rel < 0.1


@pytest.mark.cuda
def test_int8_cuda_tensors_never_take_the_plain_path(cuda):
    w32, z, d, cmask, types = random_inputs(1, 2, 8, 256, 1, torch.float32, cuda)
    w = quantized(w32, torch.bfloat16)
    calls, launches = p8.packed_score_int8_reference.calls, p8.packed_score_int8.launches
    p8.packed_score_int8(w, z.to(torch.bfloat16), d, cmask, *types, num_blocks=1)
    assert p8.packed_score_int8.launches == launches + 1
    assert p8.packed_score_int8_reference.calls == calls
    # unquantized weights, or a width the kernel does not take, raise
    with pytest.raises(ValueError):
        p8.packed_score_int8({**w, "dw1": w32["dw1"].to(torch.bfloat16)}, z.to(torch.bfloat16),
                             d, cmask, *types, num_blocks=1)
    w2, z2, d2, c2, t2 = random_inputs(1, 2, 8, 32, 1, torch.float32, cuda)
    with pytest.raises(ValueError):
        p8.packed_score_int8(quantized(w2, torch.bfloat16), z2.to(torch.bfloat16), d2, c2, *t2,
                             num_blocks=1)
    assert p8.packed_score_int8_reference.calls == calls
    assert p8.packed_score_int8.launches == launches + 1


def dense_inputs(B, N, H, L, dtype, device, seed=0):
    """One model's dense score inputs; the last 3 nodes of graph 0 are padding
    (zero node states, zero mask rows and columns, dummy distance 1)."""
    w, z, _, _, _ = random_inputs(1, B, N, H, L, dtype, device, seed=seed)
    w = {k: w[k][0].contiguous() for k in cs.W_ORDER}
    if dtype == torch.bfloat16 and H == 256:
        w = cs.with_wg_image(w)     # what the model's fused_weights() adds
    g = torch.Generator().manual_seed(seed + 1)
    m = torch.triu(torch.rand(B, N, N, generator=g) < 0.7, 1)
    m = m | m.transpose(1, 2)
    m[0, -3:, :] = m[0, :, -3:] = False
    d = torch.where(m, 0.8 + 4 * torch.rand(B, N, N, generator=g), torch.ones(B, N, N))
    z = z[0].clone()
    z[0, -3:] = 0
    embs = [torch.randn(B, N, N, H, generator=g).to(device=device, dtype=dtype) for _ in range(4)]
    return w, z.contiguous(), d.to(device), m.float().to(device), embs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("N", [8, 16, 24])
def test_dense_kernel_matches_reference(cuda, dtype, N):
    B, H, L = 3, 256, 2
    w, z, d, cmask, embs = dense_inputs(B, N, H, L, dtype, cuda, seed=N)
    launches, wg_launches = cs.condensed_score.launches, cs.condensed_score.wg_launches
    out = cs.condensed_score(w, z, d, cmask, *embs, num_blocks=L)
    torch.cuda.synchronize()
    assert cs.condensed_score.launches == launches + 1
    # bf16 takes the warp-specialised kernel, f32 the mma.sync kernel
    assert cs.condensed_score.wg_launches == wg_launches + int(dtype == torch.bfloat16)
    assert out.shape == (B, N, N, 1) and out.dtype == torch.float32
    ref = cs.condensed_score_reference(w, z, d, cmask, *embs, num_blocks=L)
    assert_close(f"dense N={N}", out, ref, dtype)      # every element, off-edge ones too


@pytest.mark.cuda
def test_dense_cuda_tensors_never_take_the_plain_path(cuda):
    w, z, d, cmask, embs = dense_inputs(2, 8, 256, 1, torch.bfloat16, cuda)
    calls, launches = cs.condensed_score_reference.calls, cs.condensed_score.launches
    cs.condensed_score(w, z, d, cmask, *embs, num_blocks=1)
    assert cs.condensed_score.launches == launches + 1
    assert cs.condensed_score_reference.calls == calls
    # a width the kernel does not take, or embeddings in another type, raise
    w2, z2, d2, c2, e2 = dense_inputs(2, 8, 32, 1, torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        cs.condensed_score(w2, z2, d2, c2, *e2, num_blocks=1)
    with pytest.raises(ValueError):
        cs.condensed_score(w, z, d, cmask, *[e.float() for e in embs], num_blocks=1)
    assert cs.condensed_score_reference.calls == calls
    assert cs.condensed_score.launches == launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("N", [8, 16, 24])
@pytest.mark.parametrize("B", [1, 3, 100])
def test_dense_wg_kernel_shapes_zero_mask_and_repeat(cuda, B, N):
    """The warp-specialised bf16 dense kernel at one, three and the dense
    path's 100 graphs, with a source node's whole row of ``cmask`` zero in
    every graph (its rows add nothing to the aggregation) and graph 0 without
    any edge: against the plain version on every element, two launches
    bitwise equal (no atomics, fixed summation order), both counted as the
    warp-specialised kernel's."""
    H, L = 256, 2
    w, z, d, cmask, embs = dense_inputs(B, N, H, L, torch.bfloat16, cuda, seed=5 * N + B)
    cmask[:, 1, :] = 0.0
    cmask[0] = 0.0
    before, wg_before = cs.condensed_score.launches, cs.condensed_score.wg_launches
    out = cs.condensed_score(w, z, d, cmask, *embs, num_blocks=L)
    again = cs.condensed_score(w, z, d, cmask, *embs, num_blocks=L)
    torch.cuda.synchronize()
    assert cs.condensed_score.launches == before + 2
    assert cs.condensed_score.wg_launches == wg_before + 2
    assert torch.equal(out, again)
    ref = cs.condensed_score_reference(w, z, d, cmask, *embs, num_blocks=L)
    assert_close(f"dense wg B={B} N={N}", out, ref, torch.bfloat16)


@pytest.mark.cuda
def test_dense_wg_kernel_needs_the_arranged_weights(cuda):
    """Without ``weights[WG_IMAGE]`` the bf16 H=256 shape raises: it does not
    give way to the mma.sync kernel or to the plain version; a wrong image
    raises too."""
    w, z, d, cmask, embs = dense_inputs(2, 8, 256, 1, torch.bfloat16, cuda)
    bare = {k: v for k, v in w.items() if k != cs.WG_IMAGE}
    calls = cs.condensed_score_reference.calls
    launches, wg_launches = cs.condensed_score.launches, cs.condensed_score.wg_launches
    with pytest.raises(ValueError):
        cs.condensed_score(bare, z, d, cmask, *embs, num_blocks=1)
    with pytest.raises(ValueError):
        cs.condensed_score({**w, cs.WG_IMAGE: w[cs.WG_IMAGE][:-8]}, z, d, cmask, *embs,
                           num_blocks=1)
    assert cs.condensed_score_reference.calls == calls
    assert (cs.condensed_score.launches, cs.condensed_score.wg_launches) == \
        (launches, wg_launches)


def stack_inputs(B, N, H, L, dtype, device, seed=0):
    """Stack weights (flax layout) and inputs; the last 3 nodes of graph 0
    are padding (zero mask rows and columns)."""
    g = torch.Generator().manual_seed(seed)

    def mat(*shape):
        return torch.randn(*shape, generator=g) / math.sqrt(shape[-2])

    def vec(*shape):
        return 0.1 * torch.randn(*shape, generator=g)

    w = dict(f1w=mat(L, H, H), f1b=vec(L, H), f2w=mat(L, H, H), f2b=vec(L, H),
             l1w=mat(L, H, H), l2w=mat(L, H, H) / N, l2b=vec(L, H), ow=mat(L, H, H), ob=vec(L, H))
    m = torch.rand(B, N, N, generator=g) < 0.7
    m = torch.triu(m, 1)
    m = m | m.transpose(1, 2)
    m[0, -3:, :] = m[0, :, -3:] = False
    w = {k: w[k].to(device=device, dtype=dtype).contiguous() for k in ss.W_KEYS}
    h = torch.randn(B, N, H, generator=g).to(device=device, dtype=dtype)
    ea = torch.randn(B, N * N, H, generator=g).to(device=device, dtype=dtype)
    c = m.reshape(B, N * N).to(device=device, dtype=dtype)
    cot = torch.randn(B, N, H, generator=g).to(device=device, dtype=dtype)
    return w, h, ea, c, cot


def assert_close(name, out, ref, dtype, tol=None):
    scale = ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs()
    print(f"{name} {dtype}: max|ref| {scale:.4g} max err {err.max().item():.3g} "
          f"mean err {err.mean().item():.3g}")
    tol_max, tol_mean = tol or TOL[dtype]
    assert torch.isfinite(out).all(), name
    assert err.max().item() <= tol_max * scale, name
    assert err.mean().item() <= tol_mean * scale, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("N", [8, 16, 24])
def test_stack_forward_matches_reference(cuda, dtype, N):
    w, h, ea, c, _ = stack_inputs(3, N, 256, 2, dtype, cuda, seed=N)
    launches, wg_launches = ss.schnet_stack_fwd.launches, ss.schnet_stack_fwd.wg_launches
    out, hs = ss.schnet_stack_fwd(w, h, ea, c)
    torch.cuda.synchronize()
    assert ss.schnet_stack_fwd.launches == launches + 1
    # bf16 takes the wgmma kernel, f32 the mma.sync one
    assert ss.schnet_stack_fwd.wg_launches == wg_launches + int(dtype == torch.bfloat16)
    ref_out, ref_hs = ss.schnet_stack_fwd_reference(w, h, ea, c)
    assert_close(f"fwd out N={N}", out, ref_out, dtype)
    assert_close(f"fwd hs N={N}", hs, ref_hs, dtype)
    b4 = ss.interaction_stack_pallas(w, h, ea.reshape(3, N, N, -1), c.reshape(3, N, N), dtype)
    torch.cuda.synchronize()
    assert_close(f"B4 out N={N}", b4, ss.interaction_stack_reference(w, h, ea, c), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [8, 16, 24])
@pytest.mark.parametrize("B", [1, 3, 200])
def test_stack_fwd_wg_kernel_shapes_zero_mask_and_repeat(cuda, B, N):
    """The wgmma forward, B3 and B4, at one, three and the training batch's
    200 graphs, with a source node's whole row of the cutoff mask zero in
    every graph and graph 0 without any edge: out and hs within TOL of the
    plain version, two launches bitwise equal (given the weight image and
    ea's tile images, or making them), B4 equal to B3's out, all counted as
    the wgmma kernel's; and the backward fed the forward's image and tile
    images equal bit for bit to the one that makes its own, within TOL."""
    L = 2
    w, h, ea, c, cot = stack_inputs(B, N, 256, L, torch.bfloat16, cuda, seed=5 * N + B)
    c = c.reshape(B, N, N).clone()
    c[:, 1, :] = 0
    c[0] = 0
    c = c.reshape(B, N * N).contiguous()
    ea4, c3 = ea.reshape(B, N, N, -1), c.reshape(B, N, N)
    fwd, b4 = ss.schnet_stack_fwd, ss.interaction_stack_pallas
    before = (fwd.launches, fwd.wg_launches, b4.launches, b4.wg_launches)
    image, ea_img = ss.stack_wg_operands(w, h, ea, c)
    out, hs = ss.schnet_stack_fwd(w, h, ea, c, image=image, ea_img=ea_img)
    out2, hs2 = ss.schnet_stack_fwd(w, h, ea, c)
    s1 = ss.interaction_stack_pallas(w, h, ea4, c3, torch.bfloat16, image=image, ea_img=ea_img)
    s2 = ss.interaction_stack_pallas(w, h, ea4, c3, torch.bfloat16)
    torch.cuda.synchronize()
    assert (fwd.launches, fwd.wg_launches, b4.launches, b4.wg_launches) == \
        tuple(n + 2 for n in before)
    assert torch.equal(out, out2) and torch.equal(hs, hs2)
    assert torch.equal(s1, out) and torch.equal(s2, out)
    ref_out, ref_hs = ss.schnet_stack_fwd_reference(w, h, ea, c)
    assert_close(f"fwd wg out B={B} N={N}", out, ref_out, torch.bfloat16)
    assert_close(f"fwd wg hs B={B} N={N}", hs, ref_hs, torch.bfloat16)
    bwd_wg = ss.schnet_stack_bwd.wg_launches
    given = ss.schnet_stack_bwd(w, ea, c, hs, cot, image=image, ea_img=ea_img)
    made = ss.schnet_stack_bwd(w, ea, c, hs, cot)
    torch.cuda.synchronize()
    assert ss.schnet_stack_bwd.wg_launches == bwd_wg + 2
    assert torch.equal(given[0], made[0]) and torch.equal(given[1], made[1])
    for k in ss.W_KEYS:
        assert torch.equal(given[2][k], made[2][k]), k
    rdh, rdea, rgrads = ss.schnet_stack_bwd_reference(w, ea, c, hs, cot)
    assert_close(f"bwd given dh B={B} N={N}", given[0], rdh, torch.bfloat16)
    assert_close(f"bwd given dea B={B} N={N}", given[1], rdea, torch.bfloat16)
    for k in ss.W_KEYS:
        assert_close(f"bwd given d{k} B={B} N={N}", given[2][k], rgrads[k], torch.bfloat16)


@pytest.mark.cuda
def test_stack_fwd_wg_kernel_needs_the_arranged_weights(cuda):
    """A misshaped or mistyped weight image or ea tile image raises before
    any launch, in B3's forward and in B4: the wgmma kernel does not give way
    to the mma.sync kernel or to the plain version."""
    w, h, ea, c, _ = stack_inputs(2, 8, 256, 1, torch.bfloat16, cuda)
    image, ea_img = ss.stack_wg_operands(w, h, ea, c)
    calls = (ss.schnet_stack_fwd_reference.calls, ss.interaction_stack_reference.calls)
    fwd, b4 = ss.schnet_stack_fwd, ss.interaction_stack_pallas
    before = (fwd.launches, fwd.wg_launches, b4.launches, b4.wg_launches)
    bad = [dict(image=x) for x in (image[:-8], image.float(), torch.cat([image, image]))]
    bad += [dict(ea_img=x) for x in (ea_img[:, :-8].contiguous(), ea_img.float(), ea_img[:1])]
    for kw in bad:
        with pytest.raises(ValueError):
            ss.schnet_stack_fwd(w, h, ea, c, **kw)
        with pytest.raises(ValueError):
            ss.interaction_stack_pallas(w, h, ea.reshape(2, 8, 8, -1), c.reshape(2, 8, 8),
                                        torch.bfloat16, **kw)
    assert calls == (ss.schnet_stack_fwd_reference.calls, ss.interaction_stack_reference.calls)
    assert (fwd.launches, fwd.wg_launches, b4.launches, b4.wg_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("N", [8, 16, 24])
def test_stack_backward_matches_reference(cuda, dtype, N):
    w, h, ea, c, cot = stack_inputs(3, N, 256, 2, dtype, cuda, seed=100 + N)
    _, hs = ss.schnet_stack_fwd_reference(w, h, ea, c)
    bwd = ss.schnet_stack_bwd
    launches, wg_launches, xty_wg = bwd.launches, bwd.wg_launches, bwd.xty_wg_launches
    dh, dea, grads = ss.schnet_stack_bwd(w, ea, c, hs, cot)
    torch.cuda.synchronize()
    assert ss.schnet_stack_bwd.launches == launches + 1
    # bf16 takes the wgmma row and weight-gradient kernels, f32 the mma.sync ones
    assert ss.schnet_stack_bwd.wg_launches == wg_launches + int(dtype == torch.bfloat16)
    assert ss.schnet_stack_bwd.xty_wg_launches == xty_wg + int(dtype == torch.bfloat16)
    rdh, rdea, rgrads = ss.schnet_stack_bwd_reference(w, ea, c, hs, cot)
    assert_close(f"bwd dh N={N}", dh, rdh, dtype)
    assert_close(f"bwd dea N={N}", dea, rdea, dtype)
    for k in ss.W_KEYS:
        assert_close(f"bwd d{k} N={N}", grads[k], rgrads[k], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [8, 16, 24])
@pytest.mark.parametrize("B", [1, 3, 200])
def test_stack_bwd_wg_kernel_shapes_zero_mask_and_repeat(cuda, B, N):
    """The wgmma row kernel at one, three and the training batch's 200
    graphs, with a source node's whole row of the cutoff mask zero in every
    graph and graph 0 without any edge: two launches bitwise equal in dh, dea
    and all nine gradients (no atomics, fixed summation orders), both counted
    as the wgmma kernel's, and both against the plain version."""
    L = 2
    w, h, ea, c, cot = stack_inputs(B, N, 256, L, torch.bfloat16, cuda, seed=7 * N + B)
    c = c.reshape(B, N, N).clone()
    c[:, 1, :] = 0
    c[0] = 0
    c = c.reshape(B, N * N).contiguous()
    _, hs = ss.schnet_stack_fwd_reference(w, h, ea, c)
    before, wg_before = ss.schnet_stack_bwd.launches, ss.schnet_stack_bwd.wg_launches
    first = ss.schnet_stack_bwd(w, ea, c, hs, cot)
    again = ss.schnet_stack_bwd(w, ea, c, hs, cot)
    torch.cuda.synchronize()
    assert ss.schnet_stack_bwd.launches == before + 2
    assert ss.schnet_stack_bwd.wg_launches == wg_before + 2
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    for k in ss.W_KEYS:
        assert torch.equal(first[2][k], again[2][k]), k
    rdh, rdea, rgrads = ss.schnet_stack_bwd_reference(w, ea, c, hs, cot)
    assert_close(f"bwd wg dh B={B} N={N}", first[0], rdh, torch.bfloat16)
    assert_close(f"bwd wg dea B={B} N={N}", first[1], rdea, torch.bfloat16)
    for k in ss.W_KEYS:
        assert_close(f"bwd wg d{k} B={B} N={N}", first[2][k], rgrads[k], torch.bfloat16)


@pytest.mark.cuda
def test_stack_bwd_wg_kernel_needs_the_arranged_weights(cuda):
    """A misshaped or mistyped weight image raises before any launch: the
    wgmma row kernel does not give way to the mma.sync kernel or to the plain
    version; the image the wrapper makes itself gives the same result as one
    passed in."""
    w, h, ea, c, cot = stack_inputs(2, 8, 256, 1, torch.bfloat16, cuda)
    _, hs = ss.schnet_stack_fwd_reference(w, h, ea, c)
    image = ss.arrange_stack_weights(w)
    calls = ss.schnet_stack_bwd_reference.calls
    launches, wg_launches = ss.schnet_stack_bwd.launches, ss.schnet_stack_bwd.wg_launches
    for bad in (image[:-8], image.float(), torch.cat([image, image])):
        with pytest.raises(ValueError):
            ss.schnet_stack_bwd(w, ea, c, hs, cot, image=bad)
    assert ss.schnet_stack_bwd_reference.calls == calls
    assert (ss.schnet_stack_bwd.launches, ss.schnet_stack_bwd.wg_launches) == \
        (launches, wg_launches)
    given = ss.schnet_stack_bwd(w, ea, c, hs, cot, image=image)
    made = ss.schnet_stack_bwd(w, ea, c, hs, cot)
    torch.cuda.synchronize()
    assert torch.equal(given[0], made[0]) and torch.equal(given[1], made[1])


@pytest.mark.cuda
def test_stack_cuda_tensors_never_take_the_plain_path(cuda):
    """Through autograd on CUDA tensors the stack launches its kernels; a
    shape the kernels do not take raises instead of falling back."""
    w, h, ea, c, cot = stack_inputs(2, 8, 256, 1, torch.float32, cuda)
    leaves = {k: v.clone().requires_grad_() for k, v in w.items()}
    calls = (ss.schnet_stack_fwd_reference.calls, ss.schnet_stack_bwd_reference.calls,
             ss.interaction_stack_reference.calls)
    launches = ss.schnet_stack_fwd.launches, ss.schnet_stack_bwd.launches
    out = ss.interaction_stack_pallas_trainable(leaves, h, ea.reshape(2, 8, 8, -1),
                                                c.reshape(2, 8, 8), torch.bfloat16)
    out.float().backward(cot.float())
    torch.cuda.synchronize()
    assert (ss.schnet_stack_fwd.launches, ss.schnet_stack_bwd.launches) == \
        (launches[0] + 1, launches[1] + 1)
    assert all(leaves[k].grad is not None and leaves[k].grad.dtype == torch.float32
               for k in ss.W_KEYS)
    w2, h2, ea2, c2, _ = stack_inputs(2, 8, 32, 1, torch.float32, cuda)
    with pytest.raises(ValueError):
        ss.schnet_stack_fwd(w2, h2, ea2, c2)
    assert calls == (ss.schnet_stack_fwd_reference.calls, ss.schnet_stack_bwd_reference.calls,
                     ss.interaction_stack_reference.calls)


def library_xty(x, y):
    """x^T y in float32 by one ``torch.mm`` call: with float32 output from
    bf16 inputs where this torch has that overload (``mm.dtype``), else in
    the inputs' type (a bf16 result, rounded once per element)."""
    try:
        return torch.mm(x.t(), y, out_dtype=torch.float32)
    except (TypeError, RuntimeError):
        return torch.mm(x.t(), y).float()


def xty_operands(B, N, L, dtype, device, seed):
    """The weight-gradient products' operands of the plain backward, per
    block, on inputs with a source node's whole mask row zero in every graph
    and graph 0 without any edge."""
    w, h, ea, c, cot = stack_inputs(B, N, 256, L, dtype, device, seed=seed)
    c = c.reshape(B, N, N).clone()
    c[:, 1, :] = 0
    c[0] = 0
    c = c.reshape(B, N * N).contiguous()
    _, hs = ss.schnet_stack_fwd_reference(w, h, ea, c)
    operands = []
    _, _, grads = ss.schnet_stack_bwd_reference(w, ea, c, hs, cot, operands=operands)
    return operands, grads


@pytest.mark.cuda
@pytest.mark.parametrize("N", [8, 16, 24])
@pytest.mark.parametrize("B", [1, 3, 200])
def test_stack_xty_wg_kernel_against_plain_and_torch_mm(cuda, B, N):
    """The wgmma weight-gradient kernel alone on the plain backward's
    operands of each block (the pair rows of B = 1, N = 8 are one stage; the
    node rows of B = 1 and 3 end inside their first or second stage): its five
    gradients within TOL of the plain products and of torch.mm, two calls
    bitwise equal, every call counted as the wgmma kernel's."""
    operands, grads = xty_operands(B, N, 2, torch.bfloat16, cuda, seed=11 * N + B)
    xty = ss.schnet_stack_xty
    before = (xty.launches, xty.wg_launches, ss.xty_reference.calls)
    for l, (xs, ys) in zip((1, 0), operands):
        out = ss.schnet_stack_xty(xs, ys)
        again = ss.schnet_stack_xty(xs, ys)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        ref = ss.xty_reference(xs, ys)
        for k, (name, _, _) in enumerate(ss.XTY_JOBS):
            assert torch.equal(ref[k], grads[name][l])
            assert_close(f"xty d{name} l={l} B={B} N={N}", out[k], ref[k], torch.bfloat16)
            assert_close(f"xty d{name} l={l} B={B} N={N} vs torch.mm", out[k],
                         library_xty(xs[k], ys[k]), torch.bfloat16)
    assert (xty.launches, xty.wg_launches, ss.xty_reference.calls) == \
        (before[0] + 4, before[1] + 4, before[2] + 2)


@pytest.mark.cuda
def test_stack_xty_takes_the_wgmma_kernel_only_for_bf16_at_256(cuda):
    """bf16 at H = 256 takes the wgmma weight-gradient kernel, in the
    backward and alone; float32 at H = 256 and bf16 at H = 128 the mma.sync
    one, within TOL of the plain products all the same."""
    xty = ss.schnet_stack_xty
    for dtype, Hs, wg in ((torch.bfloat16, 256, 1), (torch.float32, 256, 0),
                          (torch.bfloat16, 128, 0)):
        g = torch.Generator().manual_seed(Hs)
        rows = (3 * 64, 3 * 64, 24, 24, 24)
        xs = [torch.randn(r, Hs, generator=g).to(cuda, dtype) for r in rows]
        ys = [torch.randn(r, Hs, generator=g).to(cuda, dtype) for r in rows]
        before = (xty.launches, xty.wg_launches)
        out = ss.schnet_stack_xty(xs, ys)
        torch.cuda.synchronize()
        assert (xty.launches, xty.wg_launches) == (before[0] + 1, before[1] + wg), (dtype, Hs)
        ref = ss.xty_reference(xs, ys)
        for k in range(5):
            assert_close(f"xty {dtype} H={Hs} job {k}", out[k], ref[k], dtype)
    for dtype in (torch.bfloat16, torch.float32):
        w, h, ea, c, cot = stack_inputs(3, 8, 256, 1, dtype, cuda, seed=2)
        _, hs = ss.schnet_stack_fwd_reference(w, h, ea, c)
        before = ss.schnet_stack_bwd.xty_wg_launches
        ss.schnet_stack_bwd(w, ea, c, hs, cot)
        torch.cuda.synchronize()
        assert ss.schnet_stack_bwd.xty_wg_launches == before + int(dtype == torch.bfloat16)


@pytest.mark.cuda
def test_stack_xty_rejects_misshaped_scratch(cuda):
    """A misshaped, mistyped or non-contiguous operand raises before any
    launch: the kernel gives way neither to the mma.sync kernel nor to the
    plain version."""
    g = torch.Generator().manual_seed(0)
    rows = (128, 128, 16, 16, 16)
    xs = [torch.randn(r, 256, generator=g).to(cuda, torch.bfloat16) for r in rows]
    ys = [torch.randn(r, 256, generator=g).to(cuda, torch.bfloat16) for r in rows]
    bad = [
        (xs[:4], ys),                                                  # four X
        ([xs[0][:64], *xs[1:]], ys),                                   # pair rows disagree
        (xs, [*ys[:2], ys[2][:8], *ys[3:]]),                           # node rows disagree
        ([xs[0][:, :128].contiguous(), *xs[1:]], ys),                  # H disagrees
        ([xs[0].float(), *xs[1:]], ys),                                # type disagrees
        ([torch.randn(256, 128, generator=g).to(cuda, torch.bfloat16).t(), *xs[1:]], ys),
        (xs, [*ys[:4], torch.randn(16, 512, generator=g).to(cuda, torch.bfloat16)[:, ::2]]),
    ]
    xty = ss.schnet_stack_xty
    before = (xty.launches, xty.wg_launches, ss.xty_reference.calls)
    for a, b in bad:
        with pytest.raises(ValueError):
            ss.schnet_stack_xty(a, b)
    assert (xty.launches, xty.wg_launches, ss.xty_reference.calls) == before


# -- the serving walk: one CUDA graph of the sampling step per (bucket, tier) --

CKPT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "artifacts", "seeds", "ckpts")
MEMBER_SEEDS = (106, 101, 104, 102, 108, 103, 109, 105)
SERVE_RESPACING = 25


def served_graphs(count: int, seed: int) -> list[dict]:
    """``count`` synthetic reactions of the N=24 bucket (17-23 atoms)."""
    from tsdiff_tpu_torch.data.synthetic import _bend_table, make_reaction

    rng, table, out = np.random.default_rng(seed), _bend_table(), []
    while len(out) < count:
        g = make_reaction(rng, table)
        if len(g["atom_type"]) > 16:
            out.append(g)
    return out


@pytest.fixture(scope="module")
def services():
    """``services(quant, capture)``: one service per (quant, capture), made
    at first use and closed at the end of the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    from tsdiff_tpu_torch.serve import SamplerService

    made = {}

    def get(quant, capture, fused=True, seeds=MEMBER_SEEDS):
        key = (quant, capture, fused, seeds)
        if key not in made:
            made[key] = SamplerService(
                [os.path.join(CKPT_DIR, f"seed{s}_best.ckpt") for s in seeds],
                n_steps=5000, dtype="bfloat16", fused_score=fused, quant=quant,
                draft_respacing=SERVE_RESPACING, max_batch=32, capture=capture,
            )
        return made[key]

    yield get
    for svc in made.values():
        svc.close()


def served_round(svc, tier: int, seed: int):
    from tsdiff_tpu_torch.core.graph import from_numpy_graphs

    batch = from_numpy_graphs(served_graphs(tier, seed), max_nodes=24, device="cuda")
    return svc._execute(24, tier, batch, SERVE_RESPACING)


def score_kernel_launches(prof, int8: bool) -> int:
    """Launches of B1 (``int8=False``) or B5 on the card in a profile."""
    from torch.autograd import DeviceType

    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and "packed_score" in ev.key
               and ("int8" in ev.key) == int8 and "selftest" not in ev.key)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", [4, 32])
@pytest.mark.parametrize("quant", [None, "int8"], ids=["B1", "B5"])
def test_captured_round_equals_eager_round(services, quant, tier):
    captured, eager = services(quant, True), services(quant, False)
    before = captured._graphs_captured
    for seed in (tier, tier + 100):     # the second round replays the first's graph
        pos, nan = served_round(captured, tier, seed)
        ref, ref_nan = served_round(eager, tier, seed)
        print(f"{quant or 'bf16'} tier {tier} seed {seed}: max |captured - eager| "
              f"{np.abs(pos - ref).max()}, graphs recorded {captured._graphs_captured}")
        assert pos.shape == (tier, 24, 3) and np.isfinite(pos).all() and not nan
        assert not ref_nan
        np.testing.assert_array_equal(pos, ref)
        assert captured._graphs_captured == before + 1
    assert eager._graphs_captured == 0
    runner = captured._runners[(24, SERVE_RESPACING)]
    assert runner._tiers[tier].graph is not None


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [None, "int8"], ids=["B1", "B5"])
def test_captured_round_launches_the_score_kernel_once_per_step(services, quant):
    from torch.profiler import ProfilerActivity, profile

    svc = services(quant, True)
    served_round(svc, 8, seed=1)        # records the tier-8 graph
    torch.cuda.synchronize()
    before = svc._graphs_captured
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        served_round(svc, 8, seed=2)
        torch.cuda.synchronize()
    n_walk = svc._runners[(24, SERVE_RESPACING)].n_walk
    on_path = score_kernel_launches(prof, int8=quant == "int8")
    other = score_kernel_launches(prof, int8=quant != "int8")
    print(f"{quant or 'bf16'}: {on_path} launches of the score kernel in a round of "
          f"{n_walk} steps, {other} of the other")
    assert n_walk == SERVE_RESPACING
    assert (on_path, other) == (n_walk, 0)
    assert svc._graphs_captured == before


@pytest.mark.cuda
def test_captured_dense_ensemble_round_equals_eager(services):
    """Without ``fused_score`` the service walks the dense ensemble in torch
    ops; its step records and replays as the packed one does."""
    seeds = MEMBER_SEEDS[:2]
    captured, eager = services(None, True, False, seeds), services(None, False, False, seeds)
    pos, nan = served_round(captured, 4, seed=3)
    ref, _ = served_round(eager, 4, seed=3)
    assert not nan and np.isfinite(pos).all()
    np.testing.assert_array_equal(pos, ref)
    assert captured._graphs_captured == 1


@pytest.mark.cuda
def test_captured_round_traced_on_one_clock(services):
    """Under the benchmark's tracer a round that records its graph (the
    recording runs while the profiler records) and one that replays it:
    the rounds equal the eager ones bit for bit, the program's spans are no
    kernels, ``walk.record`` appears in the first round alone, and each
    round's ``walk.readback``, which waits for the card, ends after the
    round's last kernel: spans and kernels lie on one clock."""
    import sys

    from torch.autograd import DeviceType

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from portbench.trace import Tracer

    captured, eager = services(None, True), services(None, False)
    tracer = Tracer()
    tracer.start()
    rounds = [served_round(captured, 16, seed) for seed in (7, 8)]
    tracer.stop()
    for (pos, nan), seed in zip(rounds, (7, 8)):
        ref, _ = served_round(eager, 16, seed)
        assert not nan
        np.testing.assert_array_equal(pos, ref)
    kernels = tracer.summary()["kernels"]
    assert kernels and not [k for k in kernels if k[0].startswith("tsdiff.")]
    spans = [(ev.name, ev.time_range.start, ev.time_range.end) for ev in tracer.prof.events()
             if ev.device_type == DeviceType.CPU and ev.name.startswith("tsdiff.walk.")]
    walks = [sp for sp in spans if sp[0] == "tsdiff.walk.round"]
    assert len(walks) == 2
    for k, (_, r0, r1) in enumerate(walks):
        inside = [n for n, s, e in spans if r0 <= s and e <= r1]
        assert ("tsdiff.walk.record" in inside) == (k == 0), inside
        (_, _, back), = [sp for sp in spans if sp[0] == "tsdiff.walk.readback"
                         and r0 <= sp[1] <= r1]
        last = max(e for _, s, e in kernels if r0 <= s <= r1)
        print(f"round {k}: readback ends {back - last:.1f} us after the round's last kernel; "
              f"spans {inside}")
        assert last <= back


def write_reference_pt(path: str, ck: dict) -> None:
    """``ck``'s raw weights as a reference ``<iter>.pt`` (``torch.save``),
    its config an ``easydict.EasyDict`` stand-in registered for the write."""
    import sys
    import types

    from tsdiff_tpu_torch.data.convert import condensenc_state_dict_from_params

    mod = types.ModuleType("easydict")
    mod.EasyDict = type("EasyDict", (dict,), {"__module__": "easydict"})

    def easy(obj):
        return mod.EasyDict({k: easy(v) for k, v in obj.items()}) if isinstance(obj, dict) else obj

    sd = {k: torch.from_numpy(np.array(v)) for k, v in condensenc_state_dict_from_params(
        ck["params"], ck["config"]["model"]["encoder"]["num_convs"]).items()}
    saved = sys.modules.get("easydict")
    sys.modules["easydict"] = mod
    try:
        torch.save({"config": easy(ck["config"]), "model": sd, "iteration": ck["iteration"]},
                   path)
    finally:
        sys.modules.pop("easydict")
        if saved is not None:
            sys.modules["easydict"] = saved


@pytest.mark.cuda
def test_sampling_from_reference_pt_equals_ckpt(cuda, tmp_path):
    """Two trained members as reference ``.pt`` files and as ``.ckpt``
    files: the sampling CLI through B1's ``wgmma`` kernel gives the same
    samples, bit for bit."""
    import pickle

    from tsdiff_tpu_torch.cli import sampling
    from tsdiff_tpu_torch.data import save_dataset
    from tsdiff_tpu_torch.data.synthetic import make_corpus
    from tsdiff_tpu_torch.train import load_checkpoint

    ckpts = [os.path.join(CKPT_DIR, f"seed{s}_best.ckpt") for s in MEMBER_SEEDS[:2]]
    pts = []
    for path in ckpts:
        pts.append(str(tmp_path / (os.path.basename(path)[:-5] + ".pt")))
        write_reference_pt(pts[-1], load_checkpoint(path))
    test_set = str(tmp_path / "test.pkl")
    save_dataset(test_set, make_corpus(12, seed=31))
    out = {}
    for name, files in (("pt", pts), ("ckpt", ckpts)):
        ps.packed_score.launches = ps.packed_score.wg_launches = 0
        path = sampling.main(files + [
            "--test_set", test_set, "--save_dir", str(tmp_path / name), "--dtype", "bfloat16",
            "--fused_score", "--sampling_type", "ld", "--n_steps", "5000",
            "--timestep_respacing", "20", "--batch_size", "12", "--device", "cuda"])
        assert ps.packed_score.launches == ps.packed_score.wg_launches > 0
        with open(path, "rb") as f:
            out[name] = pickle.load(f)
    assert len(out["pt"]) == len(out["ckpt"]) == 12
    for a, b in zip(out["pt"], out["ckpt"]):
        assert np.isfinite(a["pos_gen"]).all()
        np.testing.assert_array_equal(a["pos_gen"], b["pos_gen"])


# -- the train and validation steps replayed from CUDA graphs -----------------

TRAIN_B = 32
TRAIN_STEPS = 10


@pytest.fixture(scope="module")
def train_inputs():
    """The trained members' model block and one batch of ``TRAIN_B``
    synthetic reactions per bucket (16, 24), on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    from tsdiff_tpu_torch.data import PaddedBatchLoader, TSDataset
    from tsdiff_tpu_torch.data.synthetic import make_corpus
    from tsdiff_tpu_torch.train import load_checkpoint

    model_cfg = load_checkpoint(os.path.join(CKPT_DIR, "seed106_best.ckpt"))["config"]["model"]
    loader = PaddedBatchLoader(TSDataset(make_corpus(300, seed=41)), TRAIN_B,
                               bucket_sizes=[16, 24], device="cuda")
    batches = {}
    for batch in loader:
        batches.setdefault(batch.pos.shape[1], batch)
    assert set(batches) == {16, 24}
    return dict(model_cfg), batches


#: the one op of a train step whose result varies between calls on identical
#: inputs on the card (a bf16 ulp now and then): F.embedding's backward into
#: the bond-type table, whose kernel compute_grad_weight_atomic_accumulate
#: sums a row's repeats with float atomics
BOND_CHAIN = {f"{part} edge_enc.bond_emb.weight" for part in ("param", "mu", "nu", "ema")}


def make_trainer(train_inputs, kind: str):
    """A bf16 model of ``kind`` ("use_pallas", B3 in the step, or
    "packed_train") from a seeded initialisation: ``(schedule, state, step,
    model)``."""
    from tsdiff_tpu_torch.config import Config
    from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
    from tsdiff_tpu_torch.models import get_model
    from tsdiff_tpu_torch.train import init_train_state, make_optimizer, make_train_step

    model_cfg, _ = train_inputs
    cfg = Config({**model_cfg, "packed_train": kind == "packed_train",
                  "use_pallas": kind == "use_pallas"})
    model = get_model(cfg, dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0)).to("cuda")
    schedule = DiffusionSchedule.from_config(cfg)
    tx = make_optimizer(Config(type="adam", lr=5e-4, beta1=0.95, beta2=0.999), 100.0)
    state = init_train_state(model, tx, ema_decay=0.999)
    return schedule, state, make_train_step(model, tx, schedule, ema_decay=0.999), model


def state_tensors(state) -> dict:
    out = {f"param {k}": v.detach() for k, v in state.params.items()}
    for part in ("mu", "nu"):
        out.update({f"{part} {k}": v for k, v in state.opt_state[part].items()})
    out.update({f"ema {k}": v for k, v in state.ema_params.items()})
    out["step"], out["count"] = state.step, state.opt_state["count"]
    return out


def lockstep(train_inputs, kind: str, buckets: list[int], lrs=None, graphs=None):
    """``TRAIN_STEPS`` train steps of three runs from one initialisation in
    lockstep, eager, eager again and replayed from ``graphs`` (a
    ``StepGraphs``, made here when None), on the fixed batches of
    ``buckets`` in turn, each step's timesteps and noise drawn before it
    from one seeded generator and the learning rate ``lrs[i]`` written into
    the device tensor before step i.  Every step of "again" and "captured"
    starts from the eager run's state, copied into theirs in place, so that
    every replay is held to the eager step.  Returns ``(steps, runs,
    graphs)``: ``steps[i][name]`` is ``(differing tensors, differing
    metrics)`` of "captured" or "again" against "eager" after step i."""
    from tsdiff_tpu_torch.diffusion.objective import draw_timesteps_and_noise
    from tsdiff_tpu_torch.train.captured import StepGraphs
    from tsdiff_tpu_torch.train.trainer import on_device

    _, batches = train_inputs
    lrs = lrs or [5e-4] * TRAIN_STEPS
    graphs = graphs or StepGraphs("cuda")
    runs = {}
    for name in ("eager", "again", "captured"):
        schedule, state, step, _ = make_trainer(train_inputs, kind)
        on_device(state)
        lr = torch.tensor(lrs[0], dtype=torch.float32, device="cuda")
        fn = (lambda step, state, lr: lambda b, t, noise: step(state, b, lr, t=t,
                                                                noise=noise)[1])(step, state, lr)
        runs[name] = dict(state=state, lr=lr, fn=fn, gen=torch.Generator(device="cuda"),
                          metrics=[])
        runs[name]["gen"].manual_seed(7)
    steps = []
    for i in range(TRAIN_STEPS):
        n = buckets[i % len(buckets)]
        start = {k: v.clone() for k, v in state_tensors(runs["eager"]["state"]).items()}
        with torch.no_grad():
            for name in ("again", "captured"):
                for k, v in state_tensors(runs[name]["state"]).items():
                    v.copy_(start[k])
        for name, r in runs.items():
            r["lr"].fill_(lrs[i])
            t, noise = draw_timesteps_and_noise(r["gen"], (TRAIN_B, n, 3), 0,
                                                len(schedule.alphas), "cuda")
            args = (batches[n], t, noise)
            m = graphs(("train", n), r["fn"], *args) if name == "captured" else r["fn"](*args)
            r["metrics"].append(m)
        ref = state_tensors(runs["eager"]["state"])
        row = {}
        for name in ("captured", "again"):
            got = state_tensors(runs[name]["state"])
            row[name] = ([k for k in ref if not torch.equal(got[k], ref[k])],
                         [k for k, v in runs[name]["metrics"][-1].items()
                          if not torch.equal(v, runs["eager"]["metrics"][-1][k])])
        steps.append(row)
    return steps, runs, graphs


def assert_as_eager(name: str, steps: list) -> None:
    """On every step, the captured step equals the eager one from the same
    state bit for bit in every metric (the gradient norm sums the bond
    table's gradient too) and in every tensor outside ``BOND_CHAIN``; the
    second eager run shows how often two eager steps differ there."""
    differ = {who: [(i, row[who]) for i, row in enumerate(steps) if row[who] != ([], [])]
              for who in ("captured", "again")}
    print(f"{name}: steps differing from the eager step: captured {differ['captured']}, eager "
          f"again {differ['again']}")
    for i, (tensors, metrics) in differ["captured"]:
        assert not metrics and set(tensors) <= BOND_CHAIN, (i, tensors, metrics)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["use_pallas", "packed_train"])
def test_captured_train_steps_equal_eager(cuda, train_inputs, kind):
    """10 steps at N=24: parameters, moments, EMA, counters and metrics."""
    calls = (ss.schnet_stack_fwd.launches, ss.schnet_stack_bwd.launches)
    steps, runs, graphs = lockstep(train_inputs, kind, [24])
    assert graphs.recorded == [("train", 24)] and graphs.replays[("train", 24)] == \
        TRAIN_STEPS - 1
    state = runs["captured"]["state"]
    assert int(state.step) == int(state.opt_state["count"]) == TRAIN_STEPS
    if kind == "use_pallas":   # eager: 2 runs x 10 steps; captured: the first step, the recording
        assert (ss.schnet_stack_fwd.launches, ss.schnet_stack_bwd.launches) == \
            (calls[0] + 2 * TRAIN_STEPS + 2, calls[1] + 2 * TRAIN_STEPS + 2)
    assert_as_eager(kind, steps)


@pytest.mark.cuda
def test_lr_changed_between_replays_takes_effect(cuda, train_inputs):
    lrs = [5e-4] * 5 + [2e-3] * 5
    steps, runs, _ = lockstep(train_inputs, "packed_train", [24], lrs=lrs)
    assert_as_eager("lr changed", steps)
    fixed, fixed_runs, _ = lockstep(train_inputs, "packed_train", [24])
    got, kept = state_tensors(runs["captured"]["state"]), \
        state_tensors(fixed_runs["captured"]["state"])
    assert max(float((got[k] - kept[k]).abs().max()) for k in got if k.startswith("param")) > 0


@pytest.mark.cuda
def test_buckets_alternating_equal_each_alone(cuda, train_inputs):
    """The graphs of two buckets in one memory pool: train steps alternating
    N=24 (recorded first) and N=16 equal the eager alternation, and the eval
    graphs replayed in alternation give what each gives replayed alone."""
    from tsdiff_tpu_torch.diffusion.objective import draw_timesteps_and_noise
    from tsdiff_tpu_torch.train import make_eval_step

    steps, runs, graphs = lockstep(train_inputs, "use_pallas", [24, 16])
    assert graphs.recorded == [("train", 24), ("train", 16)]
    assert_as_eager("alternating", steps)

    _, batches = train_inputs
    schedule, _, _, model = make_trainer(train_inputs, "use_pallas")
    ev = make_eval_step(model, schedule)
    fn = lambda b, t, noise: ev(b, t=t, noise=noise)  # noqa: E731
    draws = {n: draw_timesteps_and_noise(torch.Generator(device="cuda").manual_seed(n),
                                         (TRAIN_B, n, 3), 0, len(schedule.alphas), "cuda")
             for n in (16, 24)}
    for n in (24, 16):      # recorded in this order; the first call is eager
        graphs(("eval", n), fn, batches[n], *draws[n])
    alone = {n: [torch.stack(graphs(("eval", n), fn, batches[n], *draws[n]))
                 for _ in range(3)] for n in (16, 24)}
    mixed = {16: [], 24: []}
    for _ in range(3):
        for n in (24, 16):
            mixed[n].append(torch.stack(graphs(("eval", n), fn, batches[n], *draws[n])))
    for n in (16, 24):
        for a, m in zip(alone[n], mixed[n]):
            assert torch.equal(a, alone[n][0]) and torch.equal(m, a), n


@pytest.mark.cuda
@pytest.mark.parametrize("sidechain", [True, False])
def test_rank_of_padding_replays_the_bucket_step(cuda, sidechain):
    """A data-parallel rank's rows of a tail batch that are all padding
    replay the train step its bucket recorded on a full batch: the dual
    encoder's DSM step on protein subgraphs (the mask carried) and on the
    same graphs as molecules (no mask)."""
    from tsdiff_tpu_torch.config import Config
    from tsdiff_tpu_torch.data.dataset import PaddedBatchLoader
    from tsdiff_tpu_torch.data.pdb import cover_protein_with_subgraphs, pdb_to_graph
    from tsdiff_tpu_torch.data.synthetic import compact_protein_pdb
    from tsdiff_tpu_torch.diffusion.objective import draw_timesteps_and_noise
    from tsdiff_tpu_torch.models import get_model
    from tsdiff_tpu_torch.train import init_train_state, make_train_step
    from tsdiff_tpu_torch.train.captured import StepGraphs
    from tsdiff_tpu_torch.train.trainer import Adam, on_device

    g = pdb_to_graph(compact_protein_pdb(16, seed=1))
    subs = (cover_protein_with_subgraphs(g, np.random.default_rng(0), 6.0) * 5)[:5]
    if not sidechain:
        subs = [{k: v for k, v in s.items() if k != "is_sidechain"} for s in subs]
    cfg = dict(network="dualenc", hidden_dim=16, num_convs=2, num_convs_local=2, cutoff=10.0,
               mlp_act="relu", edge_order=3, edge_encoder="mlp", smooth_conv=False, type="dsm",
               sigma_begin=2.0, sigma_end=0.01, num_noise_level=5, beta_schedule="sigmoid",
               beta_start=1e-7, beta_end=2e-3, num_diffusion_timesteps=40)
    model = get_model(Config(cfg), generator=torch.Generator().manual_seed(0)).to(cuda)
    tx = Adam(0.9, 0.999, float("inf"))
    state = on_device(init_train_state(model, tx))
    step = make_train_step(model, tx, None, anneal_power=2.0)
    lr = torch.tensor(1e-4, device=cuda)
    fn = lambda b, t, noise: step(state, b, lr, t=t, noise=noise)[1]  # noqa: E731
    n_pad = 8 * ((max(len(s["atom_type"]) for s in subs) + 7) // 8)
    loader = PaddedBatchLoader(subs, batch_size=4, bucket_sizes=[n_pad], with_indices=True,
                               device=cuda, rows=slice(2, 4))   # rank 1 of dp=2
    graphs = StepGraphs(cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    indices = []
    for batch, idx in loader:
        indices.append(idx)
        t, noise = draw_timesteps_and_noise(gen, batch.pos.shape, 0, 5, cuda)
        graphs(("train", n_pad), fn, batch, t, noise)
        assert (batch.is_sidechain is not None) == sidechain
    assert (indices[-1][2:] == -1).all() and graphs.replays[("train", n_pad)] == 1


# -- orbax checkpoint directories on the card ---------------------------------

@pytest.mark.cuda
def test_orbax_save_snapshots_a_captured_steps_state(cuda, train_inputs, tmp_path):
    """The H=256 train state after 3 replayed train steps (its tensors the
    graph's static buffers, updated in place by every replay) saved through
    the orbax writer, and 3 more replays queued as soon as the save returns:
    the directory holds the state at the save call (held to copies taken on
    the stream just before it), bit for bit, though the live state moved."""
    from orbax_leaves import fixture_arrays

    from tsdiff_tpu_torch.config import Config
    from tsdiff_tpu_torch.diffusion.objective import draw_timesteps_and_noise
    from tsdiff_tpu_torch.train import TrainState, load_checkpoint
    from tsdiff_tpu_torch.train.captured import StepGraphs
    from tsdiff_tpu_torch.train.checkpoint import checkpoint_payload
    from tsdiff_tpu_torch.train.orbax_io import OrbaxWriter
    from tsdiff_tpu_torch.train.trainer import on_device

    model_cfg, batches = train_inputs
    schedule, state, step, _ = make_trainer(train_inputs, "use_pallas")
    on_device(state)
    lr = torch.tensor(5e-4, dtype=torch.float32, device="cuda")
    graphs = StepGraphs("cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)

    def replay():
        t, noise = draw_timesteps_and_noise(gen, (TRAIN_B, 24, 3), 0, len(schedule.alphas),
                                            "cuda")
        graphs(("train", 24), lambda b, t, noise: step(state, b, lr, t=t, noise=noise)[1],
               batches[24], t, noise)

    for _ in range(3):
        replay()
    held = {k: v.clone() for k, v in state_tensors(state).items()}
    config = Config({"model": dict(model_cfg), "train": {"optimizer": {"weight_decay": 0.0}}})
    writer = OrbaxWriter()
    path = str(tmp_path / "3.orbax")
    writer.save(path, config, state, iteration=3)
    for _ in range(3):
        replay()
    writer.wait()
    assert graphs.replays[("train", 24)] == 5
    moved = state_tensors(state)
    assert any(not torch.equal(moved[k], held[k]) for k in held if k.startswith("param"))
    part = {p: {k.split(" ", 1)[1]: v for k, v in held.items() if k.startswith(p + " ")}
            for p in ("param", "mu", "nu", "ema")}
    at_save = TrainState(part["param"], {"count": held["count"], "mu": part["mu"],
                                         "nu": part["nu"]}, held["step"], part["ema"])
    want = fixture_arrays(checkpoint_payload(config, at_save, iteration=3))
    got = fixture_arrays(load_checkpoint(path))
    assert set(got) == set(want) and len(want) > 100
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.cuda
def test_orbax_members_sample_as_ckpt_members(cuda, tmp_path):
    """Two trained members (H=256) written as ``.orbax`` directories through
    the writer and read back: the same weights, and one B1 launch on the
    card from them equal to one from the ``.ckpt`` members, bit for bit."""
    from orbax_leaves import fixture_arrays

    from tsdiff_tpu_torch.diffusion.ensemble import load_members, stack_params
    from tsdiff_tpu_torch.train import load_checkpoint
    from tsdiff_tpu_torch.train.orbax_io import write_checkpoint_orbax

    ckpts = [os.path.join(CKPT_DIR, f"seed{s}_best.ckpt") for s in MEMBER_SEEDS[:2]]
    dirs = [str(tmp_path / f"m{i}.orbax") for i in range(2)]
    for src, dst in zip(ckpts, dirs):
        write_checkpoint_orbax(dst, load_checkpoint(src))
        a, b = fixture_arrays(load_checkpoint(dst)), fixture_arrays(load_checkpoint(src))
        assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in b)
    graphs = served_graphs(6, seed=5)
    from tsdiff_tpu_torch.core.graph import from_numpy_graphs

    batch = from_numpy_graphs(graphs, max_nodes=24, device="cuda")
    outs = []
    for paths in (ckpts, dirs):
        members, _ = load_members(paths, cuda, torch.bfloat16, fused_score=True)
        model = members[0]
        pp = model.precompute_packed_pairs(batch.bond_mat, batch.node_mask)
        info = model.build_packed_pair_info(batch.pos, batch.node_mask, pp)
        with torch.no_grad():
            z = torch.stack([m.node_states(batch.atom_type, batch.r_feat, batch.p_feat,
                                           batch.node_mask) for m in members]).contiguous()
        w = stack_params([m.kernel_weights() for m in members])
        outs.append(ps.packed_score(w, z, info.d_in.contiguous(), info.cmask.contiguous(),
                                    pp.type_r_in, pp.type_p_in, pp.type_r_out, pp.type_p_out,
                                    num_blocks=model.num_convs))
    torch.cuda.synchronize()
    assert torch.isfinite(outs[0]).all() and torch.equal(outs[0], outs[1])
