"""diffusion/schedules.py and diffusion/sampler.py of the port against JAX.

* ``build_step_coeffs`` for all five update rules, with and without
  ``timestep_respacing``: identical float32 coefficients (both packages
  compute them in float64 numpy with the same formulas).
* ``dynamic_sampling`` with a 2-member packed ensemble at small width: the
  port's final positions match the JAX sampler's, for all five rules, with
  and without respacing.  JAX draws its noise inside the scan from
  ``fold_in(key_scan, k)`` after ``key_init, key_scan = split(key)``; the
  test rebuilds that stream and injects it into the port.  Tolerance
  rtol=5e-4, atol=5e-5: float32 sums in another order, over 10 steps.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tsdiff_tpu.diffusion import sampler as jsampler
from tsdiff_tpu.diffusion.ensemble import make_ensemble_score_fn as jax_ensemble
from tsdiff_tpu.diffusion.ensemble import stack_params as jax_stack
from tsdiff_tpu.diffusion.schedules import DiffusionSchedule as JaxSchedule
from tsdiff_tpu.diffusion.schedules import get_beta_schedule as jax_betas

from tsdiff_tpu_torch.config import Config as TConfig
from tsdiff_tpu_torch.diffusion import sampler as tsampler
from tsdiff_tpu_torch.diffusion.ensemble import make_packed_ensemble_eps_fn
from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule, get_beta_schedule

from test_condensenc import MODEL_CFG
from test_torch_common import close, small_setup

RULES = ["ld", "ddpm", "ddpm_noisy", "ddpm_det", "generalized"]


@pytest.mark.parametrize("name", ["quad", "linear", "const", "jsd", "sigmoid"])
def test_beta_schedules_match(name):
    kw = dict(beta_start=1e-7, beta_end=2e-3, num_diffusion_timesteps=50)
    np.testing.assert_array_equal(get_beta_schedule(name, **kw), jax_betas(name, **kw))


def test_schedule_from_config_matches():
    t = DiffusionSchedule.from_config(TConfig(MODEL_CFG))
    j = JaxSchedule.from_config(MODEL_CFG)
    np.testing.assert_array_equal(t.betas, np.asarray(j.betas))
    np.testing.assert_array_equal(t.alphas, np.asarray(j.alphas))
    np.testing.assert_allclose(t.sigmas, np.asarray(j.sigmas), rtol=1e-6)


@pytest.mark.parametrize("respacing", [None, 7], ids=["full", "respaced"])
@pytest.mark.parametrize("rule", RULES)
def test_build_step_coeffs_match(rule, respacing):
    kw = dict(sampling_type=rule, n_steps=40, step_lr=1e-6, eta=0.7,
              timestep_respacing=respacing)
    t = tsampler.build_step_coeffs(DiffusionSchedule.from_config(TConfig(MODEL_CFG)),
                                   tsampler.SamplingSettings(**kw))
    j = jsampler.build_step_coeffs(JaxSchedule.from_config(MODEL_CFG),
                                   jsampler.SamplingSettings(**kw))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_entry_modes_and_frame_scale():
    ts = DiffusionSchedule.from_config(TConfig(MODEL_CFG))
    js = JaxSchedule.from_config(MODEL_CFG)
    pos = np.random.default_rng(0).normal(size=(2, 6, 3)).astype(np.float32)
    noise = np.array(jax.random.normal(jax.random.key(1), pos.shape))
    for kw in (dict(n_steps=10), dict(n_steps=10, denoise_from_time_t=50),
               dict(n_steps=10, denoise_from_time_t=50, noise_from_time_t=30)):
        t = tsampler.initial_position(ts, tsampler.SamplingSettings(**kw), torch.from_numpy(pos),
                                      noise=torch.from_numpy(noise))
        j = jsampler.initial_position(js, jsampler.SamplingSettings(**kw), jnp.asarray(pos),
                                      jax.random.key(1))
        close(t, j, rtol=1e-6, atol=1e-6)
        assert tsampler.final_frame_scale(ts, tsampler.SamplingSettings(**kw)) == \
            jsampler.final_frame_scale(js, jsampler.SamplingSettings(**kw))


@pytest.fixture(scope="module")
def ensemble():
    return small_setup(seed=4, sizes=(5, 8, 11), n_pad=12, members=2)


@pytest.mark.parametrize("respacing", [None, 4], ids=["full", "respaced"])
@pytest.mark.parametrize("rule", RULES)
def test_dynamic_sampling_matches_jax(ensemble, rule, respacing):
    jmodel, params, jb, tmodels, tb, _ = ensemble
    kw = dict(sampling_type=rule, n_steps=10, step_lr=1e-5, timestep_respacing=respacing)
    js = JaxSchedule.from_config(MODEL_CFG)
    pos_init = jax.random.normal(jax.random.key(5), jb.pos.shape)
    key = jax.random.key(9)
    fused = jmodel.clone(fused_score=True)
    res = jsampler.dynamic_sampling(
        jax_ensemble(fused, jax_stack(params), jb), js, pos_init, jb.node_mask, key,
        jsampler.SamplingSettings(**kw),
    )
    _, key_scan = jax.random.split(key)
    steps = len(jsampler.build_step_coeffs(js, jsampler.SamplingSettings(**kw)).a)
    noise = np.stack([
        np.asarray(jax.random.normal(jax.random.fold_in(key_scan, k), pos_init.shape))
        for k in range(steps)
    ])

    out = tsampler.dynamic_sampling(
        make_packed_ensemble_eps_fn(tmodels, tb),
        DiffusionSchedule.from_config(TConfig(MODEL_CFG)),
        torch.from_numpy(np.array(pos_init)), tb.node_mask,
        tsampler.SamplingSettings(**kw), noise=torch.from_numpy(noise),
    )
    assert not bool(res.nan_detected) and not bool(out.nan_detected)
    assert out.nan_detected.dtype == torch.bool and out.nan_detected.dim() == 0
    close(out.pos, res.pos)
    # the score moves the result well beyond the tolerance
    def zero_node_eq(pos):
        return torch.zeros_like(pos)

    zero_node_eq.returns_node_eq = True
    no_score = tsampler.dynamic_sampling(
        zero_node_eq, DiffusionSchedule.from_config(TConfig(MODEL_CFG)),
        torch.from_numpy(np.array(pos_init)), tb.node_mask,
        tsampler.SamplingSettings(**kw), noise=torch.from_numpy(noise),
    )
    assert (no_score.pos - out.pos).abs().max().item() > 1e-3
