"""The port's packed training objective (``packed_train``) against the JAX
package's: the differentiable packed forward ``ops/packed_score_xla.py``, the
loss and every gradient, three optimizer steps with EMA, and the port's own
dense loss.

Inputs are made from a numpy seed: a small model (H=32, L=2) and a batch
padded to N=12 with padding atoms and an empty tail graph.  The timesteps
and noise are the JAX key's draws, injected into the port
(``test_torch_train.jax_draws``).  Tolerances:

* float32: rtol 5e-4, atol max(5e-5, 1e-4 max|g|) per gradient, as the dense
  slice (``test_diffusion_loss_and_grads_match_jax``);
* packed against dense in the port: the loss to rtol 1e-5 and each gradient
  to a relative norm below 1e-5 (the JAX package's own contract,
  ``tests/test_packed_kernel.py``);
* bfloat16: the loss within twice the gap between JAX's own bfloat16 and
  float32 packed losses on the same batch, and every gradient no further
  from JAX's float32 gradient (relative norm) than twice JAX's own bfloat16
  gradient is from it.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tsdiff_tpu.config import Config as JConfig
from tsdiff_tpu.core.graph import from_numpy_graphs as jax_from_numpy_graphs
from tsdiff_tpu.diffusion.objective import diffusion_loss as jax_loss
from tsdiff_tpu.models import get_model as jax_get_model
from tsdiff_tpu.ops.packed_score_xla import packed_score_xla as jax_packed_score_xla
from tsdiff_tpu.ops.pallas.condensed_score_packed import extract_weights_packed
from tsdiff_tpu.train import init_train_state as jax_init_state
from tsdiff_tpu.train import make_optimizer as jax_make_optimizer
from tsdiff_tpu.train import make_train_step as jax_make_train_step

from tsdiff_tpu_torch.config import Config
from tsdiff_tpu_torch.convert import params_from_jax
from tsdiff_tpu_torch.core.graph import from_numpy_graphs
from tsdiff_tpu_torch.core.packed import offset_index_tables
from tsdiff_tpu_torch.diffusion.objective import diffusion_loss
from tsdiff_tpu_torch.models import CondenseEncoderEpsNetwork
from tsdiff_tpu_torch.ops import packed_score as ps
from tsdiff_tpu_torch.train import init_train_state, make_optimizer, make_train_step

from test_condensenc import MODEL_CFG
from test_torch_common import close, make_graphs
from test_torch_train import SCHEDULE_J, SCHEDULE_T, jax_draws

PACKED_CFG = {**MODEL_CFG.to_dict(), "packed_train": True}


def empty_graph(feat_dim: int = 8) -> dict:
    return dict(atom_type=np.zeros((0,), np.int64), r_feat=np.zeros((0, feat_dim), np.float32),
                p_feat=np.zeros((0, feat_dim), np.float32), pos=np.zeros((0, 3), np.float32),
                bond_mat=np.zeros((0, 0), np.int64))


@pytest.fixture(scope="module")
def setup():
    """The JAX model and parameters, both batches, and JAX's packed loss and
    gradients in float32 and bfloat16 and its dense loss, under one key."""
    rng = np.random.default_rng(21)
    graphs = make_graphs(rng, (5, 8, 12, 7, 10)) + [empty_graph()]
    jb = jax_from_numpy_graphs(graphs, max_nodes=12)
    tb = from_numpy_graphs(graphs, max_nodes=12)
    jmodel = jax_get_model(MODEL_CFG)
    params = jmodel.init(jax.random.key(5), jb.atom_type, jb.r_feat, jb.p_feat, jb.pos,
                         jb.bond_mat, jb.node_mask)
    key = jax.random.key(13)
    out = {}
    for name, dt in (("f32", None), ("bf16", jnp.bfloat16)):
        m = jmodel.clone(packed_train=True, dtype=dt)
        (loss, aux), grads = jax.value_and_grad(
            lambda p, m=m: jax_loss(m, p, SCHEDULE_J, jb, key), has_aux=True)(params)
        out[name] = (float(loss), aux, params_from_jax(jax.device_get(grads)))
    out["dense"] = float(jax_loss(jmodel, params, SCHEDULE_J, jb, key)[0])
    t, noise = jax_draws(key, jb)
    return dict(jmodel=jmodel, params=params, jb=jb, tb=tb, t=t, noise=noise, jax=out)


def port_model(params, dtype=None, packed=True):
    cfg = Config(PACKED_CFG if packed else MODEL_CFG.to_dict())
    model = CondenseEncoderEpsNetwork.from_config(cfg, dtype=dtype)
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    return model


def port_loss_and_grads(model, s):
    loss, aux = diffusion_loss(model, SCHEDULE_T, s["tb"], t=s["t"], noise=s["noise"])
    names, tensors = zip(*model.named_parameters())
    return loss.detach(), aux, dict(zip(names, torch.autograd.grad(loss, tensors)))


def rel_norm(a, b) -> float:
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a, np.float64)
    b = np.asarray(b.detach() if isinstance(b, torch.Tensor) else b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def test_offset_index_tables_are_the_rolls():
    n, k = 10, 5
    x = torch.randn(2, k, n, 3, generator=torch.Generator().manual_seed(0))
    y = torch.randn(2, n, 3, generator=torch.Generator().manual_seed(1))
    minus, plus, unroll = offset_index_tables(n, "cpu")
    got_in = x.reshape(2, k * n, 3).index_select(1, minus).reshape(2, k, n, 3)
    got_back = x.reshape(2, k * n, 3).index_select(1, unroll).reshape(2, k, n, 3)
    got_out = y.index_select(1, plus).reshape(2, k, n, 3)
    for kk in range(1, k + 1):
        assert torch.equal(got_in[:, kk - 1], torch.roll(x[:, kk - 1], kk, dims=1))
        assert torch.equal(got_back[:, kk - 1], torch.roll(x[:, kk - 1], -kk, dims=1))
        assert torch.equal(got_out[:, kk - 1], torch.roll(y, -kk, dims=1))
    assert torch.equal(minus[unroll], torch.arange(k * n))   # inverse permutations
    assert offset_index_tables(n, "cpu")[0] is minus  # made once


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_score_xla_matches_jax(setup, dtype):
    """The packed forward alone, from the module's parameters, against the
    JAX twin on the same packed inputs: float32 at the default tolerance;
    bfloat16, where both round at the same points, within one bf16 ulp of
    the output's magnitude."""
    s = setup
    jdt, tdt = (None, None) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jm = s["jmodel"].clone(dtype=jdt)
    jb = s["jb"]
    pp = jm.precompute_packed_pairs(jb.bond_mat, jb.node_mask)
    z = jm.apply(s["params"], jb.atom_type, jb.r_feat, jb.p_feat, jb.node_mask,
                 method="node_states")
    info = jm.build_packed_pair_info(jb.pos, jb.node_mask, pp)
    want = jax_packed_score_xla(
        extract_weights_packed(s["params"]), z, info.d_in, info.cmask, pp.type_r_in,
        pp.type_p_in, pp.type_r_out, pp.type_p_out, num_blocks=jm.num_convs,
        dtype=jdt or jnp.float32)
    model = port_model(s["params"], dtype=tdt)
    tb = s["tb"]
    tpp = model.precompute_packed_pairs(tb.bond_mat, tb.node_mask)
    with torch.no_grad():
        tz = model.node_states(tb.atom_type, tb.r_feat, tb.p_feat, tb.node_mask)
        got, tinfo = model.score_step_packed_xla(tb.pos, tb.node_mask, tz, tpp)
    close(tinfo.cmask, info.cmask)
    assert got.shape == want.shape and got.dtype == torch.float32
    if dtype == "float32":
        close(got, want, atol=1e-5)
    else:
        scale = float(np.abs(np.asarray(want)).max())
        close(got, want, rtol=0, atol=scale * 2.0 ** -8)


def test_packed_loss_and_grads_match_jax(setup):
    s = setup
    jl, jaux, jgrads = s["jax"]["f32"]
    np.testing.assert_array_equal(s["t"].numpy(), np.asarray(jaux["timesteps"]))
    calls = ps.packed_score_reference.calls
    model = port_model(s["params"])
    loss, aux, grads = port_loss_and_grads(model, s)
    assert ps.packed_score_reference.calls == calls  # the plain twin of B1 is not on this path
    close(loss, jl)
    close(aux["loss_sum"], jaux["loss_sum"])
    assert float(aux["n_nodes"]) == float(jaux["n_nodes"]) == 42.0
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        scale = float(np.abs(jgrads[name].numpy()).max())
        close(g, jgrads[name], atol=max(5e-5, 1e-4 * scale))


def test_packed_loss_equals_dense_loss(setup):
    s = setup
    packed, _, g_packed = port_loss_and_grads(port_model(s["params"]), s)
    dense, _, g_dense = port_loss_and_grads(port_model(s["params"], packed=False), s)
    np.testing.assert_allclose(float(packed), float(dense), rtol=1e-5)
    np.testing.assert_allclose(float(packed), s["jax"]["dense"], rtol=1e-5)
    for name in g_dense:
        assert rel_norm(g_packed[name], g_dense[name]) < 1e-5, name


def test_packed_bf16_within_twice_jax_own_gap(setup):
    s = setup
    f32_loss, _, f32_grads = s["jax"]["f32"]
    bf_loss, _, bf_grads = s["jax"]["bf16"]
    loss, _, grads = port_loss_and_grads(port_model(s["params"], dtype=torch.bfloat16), s)
    gap = abs(bf_loss - f32_loss)
    assert gap > 0
    assert abs(float(loss) - bf_loss) <= 2 * gap
    assert abs(float(loss) - f32_loss) <= 2 * gap
    for name, g in grads.items():
        own = rel_norm(bf_grads[name], f32_grads[name])
        assert rel_norm(g, f32_grads[name]) <= 2 * own, name


def test_packed_train_steps_match_jax(setup):
    """Three Adam steps with EMA: parameters, EMA and grad_norm after each,
    as ``test_torch_train.test_train_steps_match_jax``."""
    s = setup
    opt = dict(type="adam", lr=5e-4, beta1=0.95, beta2=0.999, weight_decay=0.0)
    lr, ema_decay, max_norm = 5e-4, 0.999, 3000.0
    jmodel = s["jmodel"].clone(packed_train=True)
    jtx = jax_make_optimizer(JConfig(opt), max_norm)
    jstate = jax_init_state(jmodel, jtx, s["params"], ema_decay=ema_decay)
    jstep = jax_make_train_step(jmodel, jtx, SCHEDULE_J, ema_decay=ema_decay)
    model = port_model(s["params"])
    ttx = make_optimizer(Config(opt), max_norm)
    tstate = init_train_state(model, ttx, ema_decay=ema_decay)
    tstep = make_train_step(model, ttx, SCHEDULE_T, ema_decay=ema_decay)
    key = jax.random.key(17)
    for _ in range(3):
        key, k = jax.random.split(key)
        jstate, jm = jstep(jstate, s["jb"], k, lr)
        t, noise = jax_draws(k, s["jb"])
        tstate, tm = tstep(tstate, s["tb"], lr, t=t, noise=noise)
        close(tm["grad_norm"], jm["grad_norm"])
        for tree, got in ((jstate.params, tstate.params), (jstate.ema_params, tstate.ema_params)):
            want = params_from_jax(jax.device_get(tree))
            for name, v in got.items():
                close(v, want[name])
    assert tstate.step == 3


def test_packed_needs_mlp_encoder_and_hard_cutoff(setup):
    """JAX asserts in ``score_step_packed_xla``; the port builds such models,
    as JAX does, and its packed forward refuses them: a soft cutoff, the
    gaussian edge encoder, an activation other than swish."""
    s = setup
    smooth = s["jmodel"].clone(packed_train=True, smooth_conv=True)
    with pytest.raises(AssertionError):
        jax_loss(smooth, s["params"], SCHEDULE_J, s["jb"], jax.random.key(0))
    for change, what in (({"smooth_conv": True}, "hard cutoff"),
                         ({"edge_encoder": "gaussian"}, "mlp edge encoder"),
                         ({"mlp_act": "relu"}, "swish")):
        cfg = {**PACKED_CFG, **change}
        if "smooth_conv" in change:
            cfg["encoder"] = {**cfg["encoder"], "smooth_conv": True}
        model = CondenseEncoderEpsNetwork.from_config(Config(cfg))
        with pytest.raises(ValueError, match=what):
            diffusion_loss(model, SCHEDULE_T, s["tb"], t=s["t"], noise=s["noise"])
    model = port_model(s["params"])
    model.encoder.smooth = True
    with pytest.raises(ValueError, match="hard cutoff"):
        diffusion_loss(model, SCHEDULE_T, s["tb"], t=s["t"], noise=s["noise"])
