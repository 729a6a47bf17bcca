"""The dense fused score op (tsdiff_tpu_torch/ops/condensed_score.py) and the
model's fused ``score_step`` against the JAX package.

On the CPU the wrapper takes the plain version, so these tests hold the plain
version against JAX's fused kernel ``condensed_score_pallas`` in interpret
mode, at small width (H=32, L=2, a padded batch of 5, 8 and 11 atoms in N=12
and one of N=8), on inputs made from a numpy seed.  float32 at rtol=2e-4,
atol=2e-5 on valid edges, the JAX test's own tolerance
(tests/test_pallas_score.py): off-edge entries are don't-care there, and here
the op and the kernel agree on them too, so the op-level tests compare every
element.  bfloat16 at the packed op's tolerance: both sides round to bf16 at
the same points, so they differ by a few bf16 ulps (2^-8 relative) of the
largest score.  The CUDA kernel itself is held against the plain version in
tests/test_torch_cuda.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tsdiff_tpu.ops.pallas.condensed_score import _W_ORDER as JAX_W_ORDER
from tsdiff_tpu.ops.pallas.condensed_score import condensed_score_pallas
from tsdiff_tpu.ops.pallas.condensed_score import extract_weights as jax_extract_weights

from tsdiff_tpu_torch.diffusion.objective import diffusion_loss
from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
from tsdiff_tpu_torch.config import Config as TConfig
from tsdiff_tpu_torch.ops import condensed_score as cs
from tsdiff_tpu_torch.ops import packed_score as ps

from test_condensenc import MODEL_CFG
from test_torch_common import close, small_setup, torch_model

MATRICES = {"dw1", "c0r", "c0p", "c1w", "f1w", "f2w", "l1w", "l2w", "ow", "g0h", "g0e", "g1w"}
SETUPS = {"n12": dict(seed=0, sizes=(5, 8, 11), n_pad=12), "n8": dict(seed=1, sizes=(8, 6), n_pad=8)}


def jax_fused_inputs(jmodel, params, jb, pos):
    """(weights, z, d, cmask, 4 embeddings) as JAX's fused score_step builds them."""
    static = jmodel.apply(params, jb.atom_type, jb.r_feat, jb.p_feat, jb.bond_mat, jb.node_mask,
                          method="precompute_static")
    edges_in, d_in, _, _ = jmodel.build_pair_info(pos, jb.node_mask, static.pairs)
    cmask = ((d_in <= jmodel.cutoff) & edges_in.mask_global).astype(jnp.float32)
    return (jax_extract_weights(params), static.z, d_in, cmask, static.emb_r_in,
            static.emb_p_in, static.emb_r_out, static.emb_p_out), edges_in.mask_global


def torch_fused_inputs(tmodel, tb, pos):
    with torch.no_grad():
        static = tmodel.precompute_static(tb.atom_type, tb.r_feat, tb.p_feat, tb.bond_mat,
                                          tb.node_mask)
        edges_in, d_in, _, _ = tmodel.build_pair_info(pos, tb.node_mask, static.pairs)
    cmask = ((d_in <= tmodel.cutoff) & edges_in.mask_global).float()
    return (tmodel.fused_weights(), static.z, d_in, cmask, static.emb_r_in, static.emb_p_in,
            static.emb_r_out, static.emb_p_out)


def test_extract_weights_matches_jax_and_is_shared_with_the_packed_extraction():
    _, (params,), _, (tmodel,), _, _ = small_setup()
    jw = jax_extract_weights(params)
    tw = cs.extract_weights(tmodel.state_dict())
    assert tuple(tw) == cs.W_ORDER == JAX_W_ORDER
    for k in cs.W_ORDER:
        j = np.asarray(jw[k])
        if k in MATRICES:
            j = np.swapaxes(j, -1, -2)       # (in, out) -> (out, in)
        np.testing.assert_array_equal(tw[k].numpy(), j.reshape(tw[k].shape))
    packed = ps.extract_weights_packed(tmodel.state_dict())
    assert ps.W_ORDER == ("table", *cs.W_ORDER)
    for k in cs.W_ORDER:
        assert torch.equal(packed[k], tw[k])


@pytest.mark.parametrize("setup", sorted(SETUPS))
def test_condensed_score_reference_matches_jax_kernel_f32(setup):
    jmodel, (params,), jb, (tmodel,), tb, _ = small_setup(**SETUPS[setup])
    pos = jnp.asarray(jb.pos) + 0.05
    jargs, mask = jax_fused_inputs(jmodel, params, jb, pos)
    ref = condensed_score_pallas(*jargs, num_blocks=2, dtype=jnp.float32, interpret=True)
    targs = torch_fused_inputs(tmodel, tb, torch.from_numpy(np.array(pos)))
    calls, launches = cs.condensed_score_reference.calls, cs.condensed_score.launches
    out = cs.condensed_score(*targs, num_blocks=2)
    assert cs.condensed_score_reference.calls == calls + 1   # CPU tensors: the plain version
    assert cs.condensed_score.launches == launches
    assert out.shape == ref.shape and out.dtype == torch.float32
    m = np.asarray(mask)
    assert m.sum() > 20
    close(out.numpy()[..., 0][m], np.asarray(ref)[..., 0][m], rtol=2e-4, atol=2e-5)
    close(out, ref, rtol=2e-4, atol=2e-5)      # off-edge entries agree as well


def test_condensed_score_reference_matches_jax_kernel_bf16():
    """Same float32 inputs, both sides cast to bf16 and round at the same
    points: within 3e-2 of the largest score at the worst element and 3e-3 on
    average (a few bf16 ulps through two blocks and the head)."""
    jmodel, (params,), jb, (tmodel,), tb, _ = small_setup(**SETUPS["n12"])
    pos = jnp.asarray(jb.pos) + 0.05
    jargs, _ = jax_fused_inputs(jmodel, params, jb, pos)
    ref = np.asarray(condensed_score_pallas(*jargs, num_blocks=2, dtype=jnp.bfloat16,
                                            interpret=True))
    w, z, d, cmask, *embs = torch_fused_inputs(tmodel, tb, torch.from_numpy(np.array(pos)))
    bf = torch.bfloat16
    out = cs.condensed_score({k: v.to(bf) for k, v in w.items()}, z.to(bf), d, cmask,
                             *[e.to(bf) for e in embs], num_blocks=2).numpy()
    scale = np.abs(ref).max()
    err = np.abs(out - ref)
    assert err.max() <= 3e-2 * scale and err.mean() <= 3e-3 * scale, (err.max(), err.mean(), scale)


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
def test_fused_score_step_matches_unfused_and_jax_fused(dtype, monkeypatch):
    """The model's fused ``score_step``: against its own unfused path on valid
    edges, and against JAX's fused ``score_step`` (interpret mode) on every
    element; same edges and distances from both."""
    import tsdiff_tpu.ops.pallas.condensed_score as jcs

    orig = jcs.condensed_score_pallas
    monkeypatch.setattr(jcs, "condensed_score_pallas",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    jmodel, (params,), jb, _, tb, _ = small_setup(**SETUPS["n12"])
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype else (None, None)
    pos = np.asarray(jb.pos) + 0.05
    jfused = jmodel.clone(fused_score=True, dtype=jdt)
    ei_j, edges_j, d_j = jfused.apply(params, jb.atom_type, jb.r_feat, jb.p_feat,
                                      jnp.asarray(pos), jb.bond_mat, jb.node_mask)

    tfused = torch_model(params, dtype=tdt, cfg={**MODEL_CFG, "fused_score": True})
    tplain = torch_model(params, dtype=tdt)
    assert tfused.fused_score and not tplain.fused_score
    args = (tb.atom_type, tb.r_feat, tb.p_feat, torch.from_numpy(pos), tb.bond_mat, tb.node_mask)
    calls = cs.condensed_score_reference.calls
    with torch.no_grad():
        ei_f, edges_f, d_f = tfused(*args)
        ei_u, edges_u, d_u = tplain(*args)
    assert cs.condensed_score_reference.calls == calls + 1
    assert ei_f.shape == ei_u.shape and ei_f.dtype == torch.float32
    m = edges_f.mask_global.numpy()
    np.testing.assert_array_equal(m, np.asarray(edges_j.mask_global))
    np.testing.assert_array_equal(m, edges_u.mask_global.numpy())
    close(d_f, d_j, rtol=1e-6, atol=1e-6)
    ref = np.asarray(ei_j)
    if dtype is None:
        close(ei_f.numpy()[..., 0][m], ei_u.numpy()[..., 0][m], rtol=2e-4, atol=2e-5)
        close(ei_f, ref, rtol=2e-4, atol=2e-5)
    else:
        scale = np.abs(ref).max()
        for other in (ref, ei_u.numpy()):
            err = np.abs(ei_f.numpy() - other)[..., 0][m]
            assert err.max() <= 3e-2 * scale and err.mean() <= 3e-3 * scale, (err.max(), scale)


def test_fused_score_step_raises_under_autograd():
    """The fused op has no gradient: with autograd recording and trainable
    parameters ``score_step`` raises, with the advice of the JAX guard."""
    _, (params,), _, _, tb, _ = small_setup(**SETUPS["n12"])
    tfused = torch_model(params, cfg={**MODEL_CFG, "fused_score": True})
    args = (tb.atom_type, tb.r_feat, tb.p_feat, tb.pos, tb.bond_mat, tb.node_mask)
    with pytest.raises(NotImplementedError, match="inference-only"):
        tfused(*args)
    with torch.no_grad():
        tfused(*args)                                  # inference runs
    for p in tfused.parameters():
        p.requires_grad_(False)
    tfused(*args)                                      # nothing to differentiate: runs


def test_diffusion_loss_of_a_fused_model_takes_the_unfused_path():
    _, (params,), _, _, tb, _ = small_setup(**SETUPS["n12"])
    tfused = torch_model(params, cfg={**MODEL_CFG, "fused_score": True})
    tplain = torch_model(params)
    schedule = DiffusionSchedule.from_config(TConfig(MODEL_CFG))
    rng = np.random.default_rng(5)
    t = torch.from_numpy(rng.integers(0, 100, size=tb.pos.shape[0]))
    noise = torch.from_numpy(rng.normal(size=tuple(tb.pos.shape)).astype(np.float32))
    calls = cs.condensed_score_reference.calls
    loss_f, _ = diffusion_loss(tfused, schedule, tb, t=t, noise=noise)
    loss_u, _ = diffusion_loss(tplain, schedule, tb, t=t, noise=noise)
    assert cs.condensed_score_reference.calls == calls          # the fused op never ran
    assert loss_f.requires_grad and loss_f.item() == loss_u.item()
    loss_f.backward()
    assert all(p.grad is not None for p in tfused.parameters())


def test_condensed_score_cost_counts_the_kernel_body():
    """2*B*(7*P*H^2 + L*(2*P*H^2 + 3*N*H^2) + 2.5*P*H^2) flop, about 1.84e11
    at the dense path's shapes; bytes are the inputs and the output once."""
    B, N, H, L = 100, 24, 256, 7
    P = N * N
    z = torch.empty(B, N, H, dtype=torch.bfloat16)
    cost = cs.condensed_score_cost({"w": torch.empty(3, dtype=torch.bfloat16)}, z, L)
    assert cost["flops"] == 2 * B * (7 * P * H * H + L * (2 * P * H * H + 3 * N * H * H)
                                     + 2 * P * H * H + P * H * H // 2)
    assert 1.83e11 < cost["flops"] < 1.85e11
    assert cost["bytes"] == 2 * B * P * 4 + z.numel() * 2 + 4 * B * P * H * 2 + 6 + B * P * 4
