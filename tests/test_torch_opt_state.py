"""The optimizer state in checkpoints, between the port and the JAX package.

The port writes ``opt_state`` in the JAX package's optax-chain layout, so
JAX's ``restore_opt_state`` puts every moment on its own parameter; it
resumes from a state the JAX package wrote (optax NamedTuples, unpickled
without optax) and from the torch-named dict its earlier versions wrote.

The model has non-square widths (feat_dim 10, H=24), so a transposed or
misplaced moment shows in its shape as well as in its values.  Inputs are
made from a numpy seed and fed to both packages.  Tolerance of the resumed
steps: float32 at rtol=5e-4, atol=5e-5."""

import os
import pickle
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tsdiff_tpu.config import Config as JConfig
from tsdiff_tpu.core.graph import from_numpy_graphs as jax_from_numpy_graphs
from tsdiff_tpu.diffusion.schedules import DiffusionSchedule as JSchedule
from tsdiff_tpu.models import get_model as jax_get_model
from tsdiff_tpu.train import init_train_state as jax_init_state
from tsdiff_tpu.train import load_checkpoint as jax_load_checkpoint
from tsdiff_tpu.train import make_optimizer as jax_make_optimizer
from tsdiff_tpu.train import make_train_step as jax_make_train_step
from tsdiff_tpu.train import save_checkpoint as jax_save_checkpoint
from tsdiff_tpu.train.trainer import TrainState as JTrainState
from tsdiff_tpu.train.trainer import restore_opt_state

from tsdiff_tpu_torch.config import Config
from tsdiff_tpu_torch.convert import params_from_jax, params_to_jax
from tsdiff_tpu_torch.core.graph import from_numpy_graphs
from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
from tsdiff_tpu_torch.train import (
    TrainState,
    init_train_state,
    load_checkpoint,
    make_optimizer,
    make_train_step,
    opt_state_from_checkpoint,
    save_checkpoint,
)

from test_condensenc import MODEL_CFG
from test_torch_common import close, make_graphs
from test_torch_dense_model import port_model
from test_torch_train import jax_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = JConfig({**MODEL_CFG.to_dict(), "feat_dim": 10, "hidden_dim": 24,
               "encoder": {**MODEL_CFG.encoder.to_dict(), "hidden_dim": 24}})
SCHEDULE_T = DiffusionSchedule.from_config(Config(CFG.to_dict()))
MAX_NORM, LR, EMA = 3000.0, 5e-4, 0.999


def optimizer_cfg(weight_decay: float) -> dict:
    return dict(type="adam", lr=LR, beta1=0.95, beta2=0.999, weight_decay=weight_decay)


def setup(seed: int = 0):
    rng = np.random.default_rng(seed)
    graphs = make_graphs(rng, (5, 8, 12, 7), feat_dim=10)
    jb = jax_from_numpy_graphs(graphs, max_nodes=12)
    tb = from_numpy_graphs(graphs, max_nodes=12)
    jmodel = jax_get_model(CFG)
    params = jmodel.init(jax.random.key(seed), jb.atom_type, jb.r_feat, jb.p_feat, jb.pos,
                         jb.bond_mat, jb.node_mask)
    return jmodel, params, jb, tb


def full_config(weight_decay: float) -> dict:
    return {"model": CFG.to_dict(), "train": {"optimizer": optimizer_cfg(weight_decay)}}


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01], ids=["adam", "weight_decay"])
def test_port_checkpoint_restores_in_jax(tmp_path, weight_decay):
    """Every count, mu and nu leaf lands in place, at its template's shape,
    with the port's value (distinct random moments per leaf)."""
    jmodel, params, _, _ = setup(1)
    model = port_model(params, cfg=CFG)
    tx = make_optimizer(Config(optimizer_cfg(weight_decay)), MAX_NORM)
    state = init_train_state(model, tx, ema_decay=EMA)
    rng = np.random.default_rng(2)
    for m in ("mu", "nu"):
        for k, v in state.opt_state[m].items():
            v.copy_(torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32)))
    state.opt_state["count"] = 7
    path = str(tmp_path / "7.ckpt")
    save_checkpoint(path, Config(full_config(weight_decay)), state, iteration=7)

    jtx = jax_make_optimizer(JConfig(optimizer_cfg(weight_decay)), MAX_NORM)
    template = jtx.init(params)
    restored = restore_opt_state(template, jax_load_checkpoint(path)["opt_state"])
    assert len(restored) == len(template) == (3 if weight_decay else 2)
    adam = restored[1]
    assert int(adam.count) == 7
    for m in ("mu", "nu"):
        want = dict(leaves(params_to_jax(state.opt_state[m])))
        got = dict(leaves(jax.device_get(getattr(adam, m))))
        tmpl = dict(leaves(jax.device_get(getattr(template[1], m))))
        assert set(got) == set(want) == set(tmpl)
        for path_, v in got.items():
            assert v.shape == tmpl[path_].shape, (m, path_)
            np.testing.assert_array_equal(v, want[path_], err_msg=f"{m} {path_}")


def jax_checkpoint(tmp_path, weight_decay: float, seed: int = 3):
    """Two JAX train steps, then the JAX package's ``save_checkpoint``;
    returns the path, the model, the JAX state, batches and the key."""
    jmodel, params, jb, tb = setup(seed)
    jtx = jax_make_optimizer(JConfig(optimizer_cfg(weight_decay)), MAX_NORM)
    jstate = jax_init_state(jmodel, jtx, params, ema_decay=EMA)
    jstep = jax_make_train_step(jmodel, jtx, JSchedule.from_config(CFG), ema_decay=EMA)
    key = jax.random.key(seed)
    for _ in range(2):
        key, k = jax.random.split(key)
        jstate, _ = jstep(jstate, jb, k, LR)
    path = str(tmp_path / "2.ckpt")
    jax_save_checkpoint(path, JConfig(full_config(weight_decay)), jax.device_get(jstate),
                        iteration=2)
    return path, jstep, jstate, jb, tb, key


def port_resume(ck, weight_decay: float):
    """The train CLI's resume: weights, optimizer state and EMA of ``ck``."""
    model = port_model(ck["params"], cfg=CFG)
    ema = {k: v.clone() for k, v in params_from_jax(ck["ema_params"]).items()}
    state = TrainState(dict(model.named_parameters()), opt_state_from_checkpoint(ck, "cpu"),
                       int(ck["iteration"]), ema)
    tx = make_optimizer(Config(optimizer_cfg(weight_decay)), MAX_NORM)
    return state, make_train_step(model, tx, SCHEDULE_T, ema_decay=EMA)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01], ids=["adam", "weight_decay"])
def test_jax_checkpoint_resumes_in_port(tmp_path, weight_decay):
    """The port's next 3 steps from a JAX-written checkpoint match JAX's next
    3 steps from the same checkpoint: parameters, EMA, grad norm, count."""
    path, jstep, _, jb, tb, key = jax_checkpoint(tmp_path, weight_decay)
    with open(path, "rb") as f:
        assert b"optax" in f.read()  # the state pickles as optax NamedTuples
    jck = jax_load_checkpoint(path)
    jtx = jax_make_optimizer(JConfig(optimizer_cfg(weight_decay)), MAX_NORM)
    jparams = jax.tree_util.tree_map(jnp.asarray, jck["params"])
    jstate = JTrainState(params=jparams,
                         opt_state=restore_opt_state(jtx.init(jparams), jck["opt_state"]),
                         step=jnp.asarray(2, jnp.int32),
                         ema_params=jax.tree_util.tree_map(jnp.asarray, jck["ema_params"]))
    tstate, tstep = port_resume(load_checkpoint(path), weight_decay)
    assert tstate.opt_state["count"] == 2
    for _ in range(3):
        key, k = jax.random.split(key)
        jstate, jm = jstep(jstate, jb, k, LR)
        t, noise = jax_draws(k, jb)
        tstate, tm = tstep(tstate, tb, LR, t=t, noise=noise)
        close(tm["grad_norm"], jm["grad_norm"])
        for tree, got in ((jstate.params, tstate.params), (jstate.ema_params, tstate.ema_params)):
            want = params_from_jax(jax.device_get(tree))
            assert set(want) == set(got)
            for name, v in got.items():
                close(v, want[name])
    assert tstate.opt_state["count"] == int(jstate.opt_state[1].count) == 5


def test_old_port_checkpoint_still_resumes(tmp_path):
    """The ``{"count", "mu", "nu"}`` dict of torch-named moments that the port
    wrote before it wrote JAX's layout resumes to the same state."""
    _, params, _, _ = setup(4)
    model = port_model(params, cfg=CFG)
    state = init_train_state(model, make_optimizer(Config(optimizer_cfg(0.0)), MAX_NORM))
    rng = np.random.default_rng(5)
    for m in ("mu", "nu"):
        for v in state.opt_state[m].values():
            v.copy_(torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32)))
    state.opt_state["count"] = 4
    path = str(tmp_path / "4.ckpt")
    save_checkpoint(path, Config(full_config(0.0)), state, iteration=4)
    ck = load_checkpoint(path)
    old = dict(ck, opt_state={"count": 4, **{m: {k: v.numpy() for k, v in
                                                state.opt_state[m].items()}
                                             for m in ("mu", "nu")}})
    for got in (opt_state_from_checkpoint(ck, "cpu"), opt_state_from_checkpoint(old, "cpu")):
        assert got["count"] == 4
        for m in ("mu", "nu"):
            assert set(got[m]) == set(state.opt_state[m])
            for k, v in got[m].items():
                assert torch.equal(v, state.opt_state[m][k]), (m, k)


def test_jax_checkpoint_loads_where_jax_and_optax_cannot_import(tmp_path):
    path = jax_checkpoint(tmp_path, 0.0)[0]
    want = opt_state_from_checkpoint(load_checkpoint(path), "cpu")
    code = f"""
import sys
sys.modules["jax"] = sys.modules["optax"] = sys.modules["flax"] = None
sys.path.insert(0, {REPO!r})
from tsdiff_tpu_torch.train import load_checkpoint, opt_state_from_checkpoint
opt = opt_state_from_checkpoint(load_checkpoint({path!r}), "cpu")
assert not any(m.split(".")[0] in ("jax", "optax", "flax", "tsdiff_tpu")
               for m, v in sys.modules.items() if v is not None)
print(opt["count"], repr(sum(float(v.double().sum()) for v in opt["mu"].values())))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    count, mu_sum = out.stdout.split()
    assert int(count) == want["count"] == 2
    assert float(mu_sum) == sum(float(v.double().sum()) for v in want["mu"].values())


def test_checkpoint_unpickler_refuses_foreign_globals(tmp_path):
    path = tmp_path / "evil.ckpt"
    path.write_bytes(pickle.dumps({"format": "tsdiff_tpu.ckpt.v1", "x": os.getcwd}))
    with pytest.raises(pickle.UnpicklingError, match="posix.getcwd|os.getcwd"):
        load_checkpoint(str(path))
