"""The host side of the ``wgmma`` forward of B3 and B4, on the CPU: the one
weight image that the forward and the backward's row kernel share, the
forward's static schedule of weight stages, the order of its aggregation, the
autograd function on CPU tensors (the plain versions, which never build the
image or ``ea``'s tile images), and that function against the JAX package's
``interaction_stack_pallas_trainable`` (its Pallas kernels in interpret
mode).  Tolerances as ``tests/test_torch_schnet_stack.py``: float32 at
rtol=5e-4, atol=5e-5; bfloat16 at 2e-2 of the output's largest magnitude."""

import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsdiff_tpu.models.schnet import SchNetStackParams
from tsdiff_tpu.ops.pallas.schnet_stack_vjp import (
    interaction_stack_pallas_trainable as jax_trainable,
)

from tsdiff_tpu_torch.ops import condensed_score as cs
from tsdiff_tpu_torch.ops import packed_score as ps
from tsdiff_tpu_torch.ops import schnet_stack as ss

RTOL, ATOL = 5e-4, 5e-5
BF16_REL = 2e-2
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
#: the matrices each kernel reads from a block of the image
FWD_MATS = ("l1w_t", "f1w_t", "f2w_t", "l2w_t", "ow_t")
BWD_MATS = ("l1w_t", "f1w_t", "f2w_t", "l2w_t", "ow", "l2w", "f2w", "f1w", "l1w")


def stack_weights(L, H=256, seed=0, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)

    def t(*shape):
        return (torch.randn(*shape, generator=g) / math.sqrt(shape[-1])).to(dtype).contiguous()

    return dict(f1w=t(L, H, H), f1b=t(L, H), f2w=t(L, H, H), f2b=t(L, H), l1w=t(L, H, H),
                l2w=t(L, H, H), l2b=t(L, H), ow=t(L, H, H), ob=t(L, H))


def kernel_mat_order() -> tuple[str, ...]:
    """``csrc/schnet_stack.cu::StackMat`` as the names of ``STACK_ORDER``
    (kF1wT -> "f1w_t", kOw -> "ow")."""
    src = os.path.join(os.path.dirname(ss.__file__), os.pardir, "csrc", "schnet_stack.cu")
    with open(src) as f:
        body = re.search(r"enum StackMat \{([^}]*)\}", f.read()).group(1)
    names = [n.strip()[1:] for n in body.split(",")][:-1]   # without kStackMats
    return tuple(n[:-1].lower() + "_t" if n.endswith("T") else n.lower() for n in names)


@pytest.mark.parametrize("L", [2, 7])
def test_one_image_holds_the_forward_and_backward_matrices(L):
    """The image has ten matrices per block, in the kernel's own order; the
    forward finds its five transposed matrices and the row kernel its nine
    where each looks for them (``wimg + (l * 10 + m) * H * H``), stage by
    stage."""
    H = 256
    assert kernel_mat_order() == ss.STACK_ORDER
    w = stack_weights(L, seed=L)
    image = ss.arrange_stack_weights(w)
    assert image.shape == (L * 10 * H * H,) and image.dtype == torch.bfloat16
    assert image.is_contiguous()

    def expected(name, l):
        return w[name[:-2]][l].t() if name.endswith("_t") else w[name][l]

    blocks = ps.tile_image_inverse(image.reshape(L, 10, H * H), H, H)
    for names in (FWD_MATS, BWD_MATS):
        for name in names:
            m = ss.STACK_ORDER.index(name)
            for l in range(L):
                assert torch.equal(blocks[l, m], expected(name, l)), (name, l)
    # one 16 KB stage c of matrix m of block l, as the producers copy it
    stage = cs.STAGE_COLS * H
    for name, l, c in (("ow_t", L - 1, 7), ("l2w_t", 0, 2), ("f1w", 1, 4)):
        start = (l * 10 + ss.STACK_ORDER.index(name)) * H * H + c * stage
        assert torch.equal(ps.tile_image_inverse(image[start:start + stage], cs.STAGE_COLS, H),
                           expected(name, l)[c * cs.STAGE_COLS:(c + 1) * cs.STAGE_COLS]), name


@pytest.mark.parametrize("N,pairs", [(8, 1), (16, 2), (24, 5)])
def test_stack_fwd_schedule_by_hand(N, pairs):
    """Per block, in matrices of 8 stages: the node product xh, per tile pair
    s1 and w, then the node update's a3 and its output product: 8 (3 + 2
    pairs) stages, 104 at N = 24 and 56 at N = 16, of the five forward
    matrices only."""
    assert cs.dense_tile_pairs(N) == pairs
    sched = ss.stack_fwd_schedule(N)
    assert len(sched) == 8 * (3 + 2 * pairs)
    assert sched[:8] == [("l1w_t", c) for c in range(8)]
    tiles = sched[8:8 + 16 * pairs]
    assert tiles == ([("f1w_t", c) for c in range(8)] + [("f2w_t", c) for c in range(8)]) * pairs
    assert sched[-16:] == [("l2w_t", c) for c in range(8)] + [("ow_t", c) for c in range(8)]
    assert {k for k, _ in sched} == set(FWD_MATS)
    assert len(sched) == {8: 40, 16: 56, 24: 104}[N]


@pytest.mark.parametrize("N", [8, 16, 24])
def test_fwd_aggregation_order_against_the_plain_sum(N):
    """The forward's aggregation (``wgb::aggregate_dense_pair``), stated in
    its order: tile pair after tile pair, each target ``j`` adds the sources
    ``i`` whose row ``i*N + j`` lies in the pair, ascending.  Since the pairs
    cover the rows in order, that is bit for bit one ascending loop over
    ``i`` (``aggregate_dense_by_node``), and it is the plain version's sum up
    to the order of the float32 additions."""
    g = torch.Generator().manual_seed(N)
    F, P = 64, N * N
    wv = torch.randn(P, F, generator=g).to(torch.bfloat16)
    xh = torch.randn(N, F, generator=g).to(torch.bfloat16)
    agg = torch.zeros(N, F)
    for tp in range(cs.dense_tile_pairs(N)):
        pr0 = 2 * cs.TILE_ROWS * tp
        rows = range(pr0, min(P, pr0 + 2 * cs.TILE_ROWS))
        for j in range(N):
            for pr in (r for r in rows if r % N == j):
                agg[j] += (wv[pr] * xh[pr // N]).float()
    assert torch.equal(agg, cs.aggregate_dense_by_node(wv, xh))
    plain = (wv.reshape(N, N, F) * xh[:, None, :]).float().sum(0)
    torch.testing.assert_close(agg, plain, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(agg.to(torch.bfloat16).float(),
                               ss._aggregate(wv[None], xh[None])[0].float(), rtol=2 ** -7,
                               atol=1e-6)


def test_autograd_on_cpu_takes_the_plain_versions_without_wg_operands(monkeypatch):
    """CPU bf16 tensors at a shape the ``wgmma`` kernels take: the autograd
    function runs the plain forward and backward once each, counts no
    launch, and never arranges the weights or makes ``ea``'s tile images."""
    def refuse(*_args, **_kwargs):
        raise AssertionError("a wgmma operand was made for CPU tensors")

    for name in ("arrange_stack_weights", "ea_tile_images"):
        monkeypatch.setattr(ss, name, refuse)
    monkeypatch.setattr(ps, "tile_image", refuse)
    B, N, H, L = 2, 8, 256, 1
    w = {k: v.float().requires_grad_() for k, v in stack_weights(L, seed=5).items()}
    g = torch.Generator().manual_seed(6)
    h = torch.randn(B, N, H, generator=g).requires_grad_()
    ea = torch.randn(B, N, N, H, generator=g).requires_grad_()
    cmask = (torch.rand(B, N, N, generator=g) < 0.7).float()
    calls = ss.schnet_stack_fwd_reference.calls, ss.schnet_stack_bwd_reference.calls
    launches = (ss.schnet_stack_fwd.launches, ss.schnet_stack_fwd.wg_launches,
                ss.schnet_stack_bwd.launches, ss.schnet_stack_bwd.wg_launches)
    assert ss.stack_wg_operands(*ss.prepare_inputs(w, h, ea, cmask, torch.bfloat16)) == \
        (None, None)
    out = ss.interaction_stack_pallas_trainable(w, h, ea, cmask, torch.bfloat16)
    out.float().sum().backward()
    assert (ss.schnet_stack_fwd_reference.calls, ss.schnet_stack_bwd_reference.calls) == \
        (calls[0] + 1, calls[1] + 1)
    assert (ss.schnet_stack_fwd.launches, ss.schnet_stack_fwd.wg_launches,
            ss.schnet_stack_bwd.launches, ss.schnet_stack_bwd.wg_launches) == launches
    assert out.dtype == torch.bfloat16 and out.shape == (B, N, H)
    assert h.grad.shape == h.shape and ea.grad.shape == ea.shape
    assert all(w[k].grad is not None and w[k].grad.dtype == torch.float32 for k in ss.W_KEYS)


def test_autograd_makes_the_wg_operands_once_per_step(monkeypatch):
    """The host side of a train step on the card, with tensors on the meta
    device and the library's choice and launch stubbed: the forward makes
    the weight image and ``ea``'s tile images once and launches with them;
    the backward gets the same two tensors and makes none."""
    monkeypatch.setattr(ss, "_fwd_uses_wg", lambda *_: True)
    monkeypatch.setattr(ss, "_kernel_lib",
                        lambda: type("Lib", (), {"schnet_stack_bwd_uses_wg": lambda *_: 1,
                                                 "schnet_stack_bwd_xty_uses_wg": lambda *_: 1})())
    table = torch.empty(0, dtype=torch.int32, device="meta")
    monkeypatch.setattr(ss, "_xty_table", lambda *_: (table, 132, 141))
    launched = []
    monkeypatch.setattr(ss, "_launch", lambda fn, tensors, *ints: launched.append((fn, tensors)))
    B, N, H, L = 2, 8, 256, 2
    w = {k: v.to("meta").requires_grad_() for k, v in stack_weights(L, seed=7).items()}
    h = torch.empty(B, N, H, device="meta", requires_grad=True)
    ea = torch.empty(B, N, N, H, device="meta", requires_grad=True)
    cmask = torch.empty(B, N, N, device="meta")
    made = ss.arrange_stack_weights.calls, ss.ea_tile_images.calls
    out = ss.interaction_stack_pallas_trainable(w, h, ea, cmask, torch.bfloat16)
    torch.autograd.grad(out.float().sum(), [*w.values(), h, ea])
    assert (ss.arrange_stack_weights.calls, ss.ea_tile_images.calls) == (made[0] + 1, made[1] + 1)
    (fwd, fwd_args), (bwd, bwd_args) = launched
    assert (fwd, bwd) == ("schnet_stack_fwd_launch", "schnet_stack_bwd_launch")
    image, ea_img = fwd_args[-2:]
    assert image.shape == (L * 10 * H * H,) and ea_img.shape == (B, N * N * H)
    assert bwd_args[-3] is image and bwd_args[-2] is ea_img and bwd_args[-1] is table


def jax_setup(B=2, N=8, H=16, L=2, seed=11):
    """JAX stack weights and inputs, and the same as float32 torch tensors."""
    params = SchNetStackParams(L, H, H, H).init(jax.random.key(seed))
    weights = SchNetStackParams(L, H, H, H).apply(params)
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, N, H)).astype(np.float32)
    ea = rng.normal(size=(B, N, N, H)).astype(np.float32)
    m = np.triu(rng.random((B, N, N)) < 0.5, 1)
    m[1, :, -2:] = m[1, -2:, :] = False  # two padded nodes in the second graph
    cmask = (m | m.transpose(0, 2, 1)).astype(np.float32)
    g = rng.normal(size=(B, N, H)).astype(np.float32)
    tw = {k: torch.from_numpy(np.array(v)) for k, v in weights.items()}
    return weights, (h, ea, cmask, g), tw


def close(got, want, dtype):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max(), \
            (np.abs(got - want).max(), np.abs(want).max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_autograd_matches_jax_trainable(dtype):
    """``interaction_stack_pallas_trainable`` through ``InteractionStackFn``
    on CPU tensors: the output and every gradient (the nine weights, h, ea)
    against the JAX package's custom VJP on the same inputs."""
    jdt, tdt = DTYPES[dtype]
    weights, (h, ea, cmask, g), tw = jax_setup()

    def f(w_, h_, ea_):
        return jax_trainable(w_, h_, ea_, cmask, jdt, True)

    want, vjp = jax.vjp(f, weights, jnp.asarray(h), jnp.asarray(ea))
    jw, jdh, jdea = vjp(jnp.asarray(g).astype(jdt))

    leaves = {k: v.clone().requires_grad_() for k, v in tw.items()}
    hx = torch.from_numpy(h).requires_grad_()
    eax = torch.from_numpy(ea).requires_grad_()
    out = ss.interaction_stack_pallas_trainable(leaves, hx, eax, torch.from_numpy(cmask), tdt)
    assert out.dtype == tdt
    close(out, want.astype(jnp.float32), dtype)
    got = torch.autograd.grad(out, [*leaves.values(), hx, eax], torch.from_numpy(g).to(tdt))
    for k, gk in zip(leaves, got):
        assert gk.dtype == torch.float32 and gk.shape == tw[k].shape
        close(gk, jw[k], dtype)
    close(got[-2], jdh, dtype)
    close(got[-1], jdea, dtype)
