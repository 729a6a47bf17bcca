"""The dense sampling paths of the port against the JAX package: one fused
model, the dense ensemble, and the packed and int8 ensembles against the dense
one.

Small width (H=32, L=2; 5, 8 and 11 atoms padded to N=12), ``ld`` for 4 steps
at step_lr=1e-6 as the JAX package's own sampler tests run it, float32.  JAX
draws its step noise inside the scan from ``fold_in(key_scan, k)``; the tests
rebuild that stream with numpy arrays and inject it into the port.  JAX's
fused dense kernel runs in interpret mode.  Tolerances: port against JAX
rtol=5e-4, atol=5e-5 (float32 sums in another order, over 4 steps); packed
against dense rtol=1e-4, atol=1e-5 and int8 against dense atol=5e-3, the JAX
tests' own (tests/test_packed_kernel.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tsdiff_tpu.diffusion import sampler as jsampler
from tsdiff_tpu.diffusion.ensemble import make_ensemble_score_fn as jax_ensemble_score_fn
from tsdiff_tpu.diffusion.ensemble import make_score_fn as jax_make_score_fn
from tsdiff_tpu.diffusion.ensemble import stack_params as jax_stack
from tsdiff_tpu.diffusion.schedules import DiffusionSchedule as JaxSchedule

from tsdiff_tpu_torch.config import Config as TConfig
from tsdiff_tpu_torch.diffusion import sampler as tsampler
from tsdiff_tpu_torch.diffusion.ensemble import (
    make_ensemble_score_fn,
    make_packed_ensemble_eps_fn,
    make_score_fn,
)
from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
from tsdiff_tpu_torch.ops import condensed_score as cs
from tsdiff_tpu_torch.ops import packed_score as ps
from tsdiff_tpu_torch.ops import packed_score_int8 as p8

from test_condensenc import MODEL_CFG
from test_torch_common import close, small_setup, torch_model

KW = dict(sampling_type="ld", n_steps=4, step_lr=1e-6)


@pytest.fixture(scope="module")
def setup():
    jmodel, params, jb, tmodels, tb, _ = small_setup(seed=4, sizes=(5, 8, 11), n_pad=12, members=2)
    js = JaxSchedule.from_config(MODEL_CFG)
    pos_init = jax.random.normal(jax.random.key(5), jb.pos.shape)
    key = jax.random.key(9)
    _, key_scan = jax.random.split(key)
    noise = np.stack([
        np.asarray(jax.random.normal(jax.random.fold_in(key_scan, k), pos_init.shape))
        for k in range(KW["n_steps"])
    ])
    return dict(jmodel=jmodel, params=params, jb=jb, tmodels=tmodels, tb=tb, js=js,
                pos_init=pos_init, key=key, noise=torch.from_numpy(noise),
                ts=DiffusionSchedule.from_config(TConfig(MODEL_CFG)))


def jax_run(s, score_fn):
    res = jsampler.dynamic_sampling(score_fn, s["js"], s["pos_init"], s["jb"].node_mask, s["key"],
                                    jsampler.SamplingSettings(**KW))
    assert not bool(res.nan_detected)
    return np.asarray(res.pos)


def torch_run(s, score_fn):
    res = tsampler.dynamic_sampling(score_fn, s["ts"], torch.from_numpy(np.array(s["pos_init"])),
                                    s["tb"].node_mask, tsampler.SamplingSettings(**KW),
                                    noise=s["noise"])
    assert not bool(res.nan_detected)
    return res.pos.numpy()


def members(s, **cfg):
    return [torch_model(p, cfg={**MODEL_CFG, **cfg}) for p in s["params"]]


@pytest.fixture(scope="module")
def dense_pos(setup):
    """The port's dense 2-member ensemble, the yardstick of the packed paths."""
    score_fn = make_ensemble_score_fn(setup["tmodels"], setup["tb"])
    assert not getattr(score_fn, "returns_node_eq", False)
    return torch_run(setup, score_fn)


def test_fused_single_model_sampling_matches_jax(setup, monkeypatch):
    """make_score_fn with fused_score -> dynamic_sampling: every step is one
    call of the fused dense score op (JAX: its kernel in interpret mode)."""
    import tsdiff_tpu.ops.pallas.condensed_score as jcs

    orig = jcs.condensed_score_pallas
    monkeypatch.setattr(jcs, "condensed_score_pallas",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    s = setup
    ref = jax_run(s, jax_make_score_fn(s["jmodel"].clone(fused_score=True), s["params"][0],
                                       s["jb"]))
    model = members(s, fused_score=True)[0]
    calls = cs.condensed_score_reference.calls
    score_fn = make_score_fn(model, s["tb"])
    assert not getattr(score_fn, "returns_node_eq", False)
    out = torch_run(s, score_fn)
    assert cs.condensed_score_reference.calls == calls + KW["n_steps"]
    close(out, ref)
    # and the unfused single model gives the same samples
    close(torch_run(s, make_score_fn(s["tmodels"][0], s["tb"])), ref)


def test_dense_ensemble_sampling_matches_jax(setup, dense_pos):
    s = setup
    ref = jax_run(s, jax_ensemble_score_fn(s["jmodel"], jax_stack(s["params"]), s["jb"]))
    close(dense_pos, ref)
    # the ensemble is not one of its members
    single = torch_run(s, make_score_fn(s["tmodels"][0], s["tb"]))
    assert np.abs(single - dense_pos).max() > 1e-4


def test_dense_score_fn_is_the_member_mean_on_shared_pair_info(setup):
    s = setup
    tb = s["tb"]
    pos = torch.from_numpy(np.array(s["pos_init"])) * tb.node_mask[..., None]
    edge_inv, emask, d = make_ensemble_score_fn(s["tmodels"], tb)(pos)
    singles = [make_score_fn(m, tb)(pos) for m in s["tmodels"]]
    close(edge_inv, torch.stack([o[0] for o in singles]).mean(0), rtol=1e-6, atol=1e-6)
    assert torch.equal(emask, singles[0][1]) and torch.equal(d, singles[0][2])
    assert edge_inv.shape == (*pos.shape[:2], pos.shape[1], 1)


def test_packed_ensemble_sampling_equals_dense(setup, dense_pos):
    """fused_score members make make_ensemble_score_fn return the packed path."""
    s = setup
    calls = ps.packed_score_reference.calls
    score_fn = make_ensemble_score_fn(members(s, fused_score=True), s["tb"])
    assert score_fn.returns_node_eq
    out = torch_run(s, score_fn)
    assert ps.packed_score_reference.calls == calls + KW["n_steps"]   # one call for both members
    np.testing.assert_allclose(out, dense_pos, rtol=1e-4, atol=1e-5)


def test_int8_ensemble_sampling_close_to_dense(setup, dense_pos):
    s = setup
    calls = p8.packed_score_int8_reference.calls, ps.packed_score_reference.calls
    score_fn = make_ensemble_score_fn(members(s, fused_score=True, score_quant="int8"), s["tb"])
    assert score_fn.returns_node_eq
    out = torch_run(s, score_fn)
    assert p8.packed_score_int8_reference.calls == calls[0] + KW["n_steps"]
    assert ps.packed_score_reference.calls == calls[1]
    np.testing.assert_allclose(out, dense_pos, rtol=0, atol=5e-3)
    assert np.abs(out - dense_pos).max() > 0          # quantized: not the same numbers


def test_sampler_tells_score_functions_apart_by_returns_node_eq(setup):
    """A node_eq function without the mark is taken for a dense score function."""
    s = setup
    node_eq_fn = make_packed_ensemble_eps_fn(s["tmodels"], s["tb"])
    assert node_eq_fn.returns_node_eq
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        torch_run(s, lambda pos: node_eq_fn(pos))
