"""The port's dense score network (the training forward) against the JAX
package: geometry, the dense forward with and without the fused stack, at
small width and on a trained checkpoint at full width, checkpoints written
by the port and read by the JAX package, and a fresh initialisation.

Inputs are made from a numpy seed and fed to both packages; JAX runs on the
CPU with ``use_pallas=False``, which computes the same function as the fused
stack (its Mosaic kernel needs a TPU).  Tolerance: float32 at rtol=5e-4,
atol=5e-5 unless a test says otherwise."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tsdiff_tpu.config import Config as JConfig
from tsdiff_tpu.core import geometry as jgeo
from tsdiff_tpu.core.graph import from_numpy_graphs as jax_from_numpy_graphs
from tsdiff_tpu.core.graph_ops import radius_edge_mask as jax_radius_edge_mask
from tsdiff_tpu.models import get_model as jax_get_model
from tsdiff_tpu.train import load_checkpoint as jax_load_checkpoint

from tsdiff_tpu_torch.config import Config
from tsdiff_tpu_torch.convert import params_from_jax, params_to_jax
from tsdiff_tpu_torch.core import geometry as tgeo
from tsdiff_tpu_torch.core.graph import from_numpy_graphs
from tsdiff_tpu_torch.core.graph_ops import radius_edge_mask
from tsdiff_tpu_torch.data.synthetic import make_corpus
from tsdiff_tpu_torch.models import CondenseEncoderEpsNetwork, get_model
from tsdiff_tpu_torch.ops import schnet_stack as ss
from tsdiff_tpu_torch.train import init_train_state, load_checkpoint, make_optimizer
from tsdiff_tpu_torch.train.checkpoint import save_checkpoint

from test_condensenc import MODEL_CFG
from test_torch_common import close, small_setup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "artifacts", "seeds", "ckpts", "seed106_best.ckpt")


def port_model(params, use_pallas=False, cfg=MODEL_CFG, dtype=None):
    c = Config({**cfg.to_dict(), "use_pallas": use_pallas})
    model = CondenseEncoderEpsNetwork.from_config(c, dtype=dtype)
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    return model


def apply_both(jmodel, params, jb, tmodel, tb):
    want = jmodel.apply(params, jb.atom_type, jb.r_feat, jb.p_feat, jb.pos, jb.bond_mat,
                        jb.node_mask)
    with torch.no_grad():
        got = tmodel(tb.atom_type, tb.r_feat, tb.p_feat, tb.pos, tb.bond_mat, tb.node_mask)
    return want, got


def test_geometry_matches_jax():
    _, _, jb, _, tb, _ = small_setup(seed=2)
    rng = np.random.default_rng(2)
    emask = np.array(jax_radius_edge_mask(jb.pos, jb.node_mask, 3.0))
    np.testing.assert_array_equal(radius_edge_mask(tb.pos, tb.node_mask, 3.0).numpy(), emask)
    score = rng.normal(size=emask.shape).astype(np.float32)
    te = torch.from_numpy(emask)
    close(tgeo.pairwise_distance(tb.pos, te), jgeo.pairwise_distance(jb.pos, emask))
    close(tgeo.eq_transform(torch.from_numpy(score), tb.pos, te),
          jgeo.eq_transform(jnp.asarray(score), jb.pos, emask))
    # the dummy distance keeps autograd finite at masked entries and the diagonal
    pos = tb.pos.clone().requires_grad_()
    tgeo.pairwise_distance(pos, te).sum().backward()
    assert torch.isfinite(pos.grad).all()


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "fused"])
def test_dense_forward_matches_jax(use_pallas):
    jmodel, (params,), jb, _, tb, _ = small_setup(seed=4)
    tmodel = port_model(params, use_pallas)
    calls = ss.schnet_stack_fwd_reference.calls
    (j_inv, j_edges, j_d), (t_inv, t_edges, t_d) = apply_both(jmodel, params, jb, tmodel, tb)
    assert ss.schnet_stack_fwd_reference.calls == calls + int(use_pallas)
    assert t_inv.shape == (4, 12, 12, 1) and t_inv.dtype == torch.float32
    close(t_inv, j_inv)
    np.testing.assert_array_equal(t_edges.mask_global.numpy(), np.asarray(j_edges.mask_global))
    close(t_d, j_d)


def test_dense_forward_trained_checkpoint_full_width():
    """seed106 at full width (H=256, L=7), B=2 synthetic reactions at N=12.
    atol 1e-4: seven float32 blocks of width 256 in another summation order."""
    ck = load_checkpoint(CKPT)
    graphs = [g for g in make_corpus(40, seed=11) if len(g["atom_type"]) <= 12][:2]
    jmodel = jax_get_model(JConfig(ck["config"]).model)
    params = {"params": ck["params"]["params"]}
    jb = jax_from_numpy_graphs(graphs, max_nodes=12)
    tb = from_numpy_graphs(graphs, max_nodes=12)
    tmodel = port_model(params, use_pallas=True, cfg=JConfig(ck["config"]).model)
    (j_inv, _, j_d), (t_inv, _, t_d) = apply_both(jmodel, params, jb, tmodel, tb)
    close(t_inv, j_inv, atol=1e-4)
    close(t_d, j_d)


def test_checkpoint_round_trip_with_jax(tmp_path):
    """The trained tree survives torch and back unchanged; a checkpoint the
    port writes loads in the JAX package, whose model reproduces the port's
    edge_inv, and in the port's own loader."""
    ck = load_checkpoint(CKPT)
    back = params_to_jax(params_from_jax(ck["params"]))
    want = jax.tree_util.tree_flatten_with_path(ck["params"])[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)

    jmodel, (params,), jb, _, tb, _ = small_setup(seed=8)
    tmodel = port_model(params)
    state = init_train_state(tmodel, make_optimizer(Config(type="adam", beta1=0.95, beta2=0.999),
                                                    3000.0), ema_decay=0.999)
    path = str(tmp_path / "7.ckpt")
    save_checkpoint(path, Config(model=MODEL_CFG.to_dict()), state, {"lr": 1.0}, iteration=7)
    jck = jax_load_checkpoint(path)
    assert jck["iteration"] == 7 and jck["scheduler"] == {"lr": 1.0}
    (j_inv, _, _), (t_inv, _, _) = apply_both(jmodel, jck["params"], jb, tmodel, tb)
    close(t_inv, j_inv)
    (j_ema, _, _), _ = apply_both(jmodel, jck["ema_params"], jb, tmodel, tb)
    close(t_inv, j_ema)
    reloaded = port_model(load_checkpoint(path)["params"])
    for k, v in tmodel.state_dict().items():
        assert torch.equal(reloaded.state_dict()[k], v)


def test_fresh_init_matches_jax_shapes_and_scale():
    """The port's init draws every tensor as the JAX package's model.init:
    the same tree, and a std within 10% for tensors of >= 1024 elements."""
    _, (params,), _, _, _, _ = small_setup(seed=1)
    tmodel = get_model(Config(MODEL_CFG.to_dict()), generator=torch.Generator().manual_seed(1))
    got = dict(jax.tree_util.tree_flatten_with_path(params_to_jax(tmodel.state_dict()))[0])
    want = dict(jax.tree_util.tree_flatten_with_path(jax.device_get(params))[0])
    assert got.keys() == want.keys()
    checked = 0
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        if w.size >= 1024:
            assert abs(got[path].std() / np.std(w) - 1) < 0.1, path
            checked += 1
    assert checked >= 8
    assert not tmodel.encoder.stack.l2b.any()
