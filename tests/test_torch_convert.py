"""Weights carried across (tsdiff_tpu_torch.convert, train/checkpoint.py).

* A flax tree from ``model.init`` maps one-to-one onto the port's modules:
  every leaf lands on exactly one torch parameter, kernels transposed, the
  layer stacks as they are, and the torch module loads it strictly.
* A trained checkpoint loads and converts with JAX unavailable.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import pytest

from tsdiff_tpu_torch.convert import params_from_jax, torch_name
from tsdiff_tpu_torch.train import load_checkpoint, select_params

from test_torch_common import small_setup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "artifacts", "seeds", "ckpts", "seed106_best.ckpt")


def test_params_from_jax_round_trips_init_tree():
    _, (params,), _, (tmodel,), _, _ = small_setup()
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(params["params"]))[0]
    sd = params_from_jax(jax.device_get(params))
    assert len(sd) == len(flat)
    assert set(sd) == set(tmodel.state_dict())
    for path, leaf in flat:
        keys = tuple(p.key for p in path)
        name = torch_name(keys)
        expect = np.asarray(leaf).T if keys[-1] == "kernel" else np.asarray(leaf)
        np.testing.assert_array_equal(sd[name].numpy(), expect)
        np.testing.assert_array_equal(tmodel.state_dict()[name].numpy(), expect)


def test_torch_names():
    assert torch_name(("edge_enc", "mlp", "layers_1", "Dense_0", "kernel")) == \
        "edge_enc.mlp.layers.1.weight"
    assert torch_name(("edge_enc", "bond_emb", "embedding")) == "edge_enc.bond_emb.weight"
    assert torch_name(("encoder", "stack", "f1w")) == "encoder.stack.f1w"
    assert torch_name(("grad_dist_mlp", "layers_2", "Dense_0", "bias")) == \
        "grad_dist_mlp.layers.2.bias"


def test_select_params():
    ck = {"params": {"a": 1}, "ema_params": None}
    assert select_params(ck, True) == ({"a": 1}, False)
    ck["ema_params"] = {"a": 2}
    assert select_params(ck, True) == ({"a": 2}, True)
    assert select_params(ck, False) == ({"a": 1}, False)


def test_load_checkpoint_rejects_other_formats(tmp_path):
    import pickle

    p = tmp_path / "x.ckpt"
    p.write_bytes(pickle.dumps({"format": "something-else"}))
    with pytest.raises(ValueError):
        load_checkpoint(str(p))
    # a directory is read as an orbax checkpoint (tests/test_torch_orbax.py):
    # one without its meta file raises, as the JAX package's load does
    with pytest.raises(FileNotFoundError, match=r"\.meta\.json"):
        load_checkpoint(str(tmp_path))


def test_trained_checkpoint_loads_without_jax():
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.path.insert(0, {REPO!r})
from tsdiff_tpu_torch.config import Config
from tsdiff_tpu_torch.convert import params_from_jax
from tsdiff_tpu_torch.models import CondenseEncoderEpsNetwork
from tsdiff_tpu_torch.train import load_checkpoint, select_params
ck = load_checkpoint({CKPT!r})
model = CondenseEncoderEpsNetwork.from_config(Config(ck["config"]).model)
model.load_state_dict(params_from_jax(select_params(ck, False)[0]))
assert model.edge_cat.lin0.weight.shape == (256, 512)
assert model.encoder.stack.f1w.shape == (7, 256, 256)
assert not any(m == "tsdiff_tpu" or m.startswith("tsdiff_tpu.") for m in sys.modules)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
