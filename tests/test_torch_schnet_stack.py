"""The port's fused SchNet stack (TPU kernels B3 and B4) against the JAX
package, through the plain versions that CPU tensors take.

Inputs are made from a numpy seed and fed to both packages; the JAX side
runs the Pallas kernels in interpret mode, as ``tests/test_pallas_vjp.py``
does.  Tolerances: float32 at rtol=5e-4, atol=5e-5 (the same float32
operations in another order).  bfloat16 at 2e-2 of the output's largest
magnitude: both round to bf16 at the same points, but a float32 sum taken in
another order can flip a rounding by one bf16 ulp (2^-8), and such flips
propagate through the blocks."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tsdiff_tpu.models.schnet import SchNetStackParams
from tsdiff_tpu.ops.pallas.schnet_stack import interaction_stack_pallas as jax_stack
from tsdiff_tpu.ops.pallas.schnet_stack_vjp import (
    _fwd_impl,
    interaction_stack_pallas_trainable as jax_trainable,
)

from tsdiff_tpu_torch.models.schnet import interaction_stack_xla
from tsdiff_tpu_torch.ops import schnet_stack as ss

RTOL, ATOL = 5e-4, 5e-5
BF16_REL = 2e-2
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def setup(B=2, N=8, H=16, L=2, seed=3):
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
    t = [torch.from_numpy(x) for x in (h, ea, cmask, g)]
    return weights, (h, ea, cmask, g), tw, t


def close(got, want, dtype, rel_scale=None):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        scale = np.abs(want).max() if rel_scale is None else rel_scale
        assert np.abs(got - want).max() <= BF16_REL * scale, (np.abs(got - want).max(), scale)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_forward_matches_jax_kernels(dtype):
    jdt, tdt = DTYPES[dtype]
    weights, (h, ea, cmask, _), tw, (th, tea, tc, _) = setup()
    want_out, (*_, want_hs) = _fwd_impl(weights, h, ea, cmask, jdt, True)
    want_b4 = jax_stack(weights, h, ea, cmask, dtype=jdt, interpret=True)

    w, hv, eav, cv = ss.prepare_inputs(tw, th, tea, tc, tdt)
    calls = ss.schnet_stack_fwd_reference.calls
    out, hs = ss.schnet_stack_fwd(w, hv, eav, cv)   # CPU tensors: the plain version
    assert ss.schnet_stack_fwd_reference.calls == calls + 1
    b4 = ss.interaction_stack_pallas(tw, th, tea, tc, tdt)
    assert out.dtype == hs.dtype == b4.dtype == tdt
    assert hs.shape == (2, 2, 8, 16)
    close(out, want_out.astype(jnp.float32), dtype)
    close(hs, want_hs.astype(jnp.float32), dtype)
    close(b4, want_b4.astype(jnp.float32), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_backward_matches_jax_vjp(dtype):
    jdt, tdt = DTYPES[dtype]
    weights, (h, ea, cmask, g), tw, (th, tea, tc, tg) = setup(seed=5)

    def f(w_, h_, ea_):
        return jax_trainable(w_, h_, ea_, cmask, jdt, True)

    _, vjp = jax.vjp(f, weights, jnp.asarray(h), jnp.asarray(ea))
    jw, jdh, jdea = vjp(jnp.asarray(g).astype(jdt))  # the output's type

    w, hv, eav, cv = ss.prepare_inputs(tw, th, tea, tc, tdt)
    _, hs = ss.schnet_stack_fwd(w, hv, eav, cv)
    dh, dea, grads = ss.schnet_stack_bwd(w, eav, cv, hs, tg.to(tdt))
    assert dh.dtype == dea.dtype == torch.float32
    close(dh, jdh, dtype)
    close(dea.reshape(tea.shape), jdea, dtype)
    for k in ss.W_KEYS:
        assert grads[k].shape == tw[k].shape
        close(grads[k], jw[k], dtype)


def test_backward_matches_autograd_of_plain_stack():
    """float32: the explicit backward equals autograd of the plain stack, and
    the autograd function (on CPU tensors) gives the same gradients."""
    _, _, tw, (th, tea, tc, tg) = setup(seed=7)
    leaves = {k: v.clone().requires_grad_() for k, v in tw.items()}
    hx, eax = th.clone().requires_grad_(), tea.clone().requires_grad_()
    out = interaction_stack_xla(leaves, hx, eax, tc)
    want = torch.autograd.grad(out, [*leaves.values(), hx, eax], tg)

    w, hv, eav, cv = ss.prepare_inputs(tw, th, tea, tc, torch.float32)
    _, hs = ss.schnet_stack_fwd(w, hv, eav, cv)
    dh, dea, grads = ss.schnet_stack_bwd(w, eav, cv, hs, tg)
    for k, wg in zip(leaves, want):
        close(grads[k], wg.numpy(), "f32")
    close(dh, want[-2].numpy(), "f32")
    close(dea.reshape(tea.shape), want[-1].numpy(), "f32")

    leaves2 = {k: v.clone().requires_grad_() for k, v in tw.items()}
    hy, eay = th.clone().requires_grad_(), tea.clone().requires_grad_()
    calls = ss.schnet_stack_bwd_reference.calls
    out2 = ss.interaction_stack_pallas_trainable(leaves2, hy, eay, tc)
    close(out2, out.detach().numpy(), "f32")
    got = torch.autograd.grad(out2, [*leaves2.values(), hy, eay], tg)
    assert ss.schnet_stack_bwd_reference.calls == calls + 1
    for a, b in zip(got, want):
        close(a, b.numpy(), "f32")


def test_cost_counts():
    """The forward's flop are the TPU kernel's estimate; the backward's are
    counted from _bwd_kernel's body (sizing figures of the training shape)."""
    fwd = ss.schnet_stack_cost(200, 24, 256, 7, torch.bfloat16, "fwd")
    bwd = ss.schnet_stack_cost(200, 24, 256, 7, torch.bfloat16, "bwd")
    P, H = 576, 256
    assert fwd["flops"] == 2 * 200 * 7 * (2 * P * H * H + 3 * 24 * H * H)
    assert abs(fwd["flops"] / 2.25e11 - 1) < 0.01
    assert abs(bwd["flops"] / 6.7e11 - 1) < 0.01
    assert ss.schnet_stack_cost(200, 24, 256, 7, torch.bfloat16, "stack")["bytes"] < fwd["bytes"]
    # the backward's row kernels and weight-gradient kernels share its flop
    rows = ss.schnet_stack_cost(200, 24, 256, 7, torch.bfloat16, "bwd_rows")
    xty = ss.schnet_stack_cost(200, 24, 256, 7, torch.bfloat16, "bwd_xty")
    assert rows["flops"] == 2 * 200 * 7 * (4 * P * H * H + 5 * 24 * H * H)
    assert abs(rows["flops"] / 4.45e11 - 1) < 0.01 and abs(xty["flops"] / 2.25e11 - 1) < 0.01
    assert rows["flops"] + xty["flops"] == bwd["flops"]
    # both write or read the per-block scratch between them, which the whole
    # backward's count does not see
    assert rows["bytes"] > bwd["bytes"] and xty["bytes"] > bwd["bytes"]
