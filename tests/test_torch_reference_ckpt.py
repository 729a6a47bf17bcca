"""Reference ``.pt`` checkpoints in the port against the JAX package.

The port's reader (``tsdiff_tpu_torch/data/torch_reader.py``) and converter
(``data/convert.py``) against the JAX package's on the same files: every
tensor bit for bit, the converted payload leaf for leaf, the convert CLI's
files equal.  A model the port loads from a ``.pt`` gives JAX's packed
ensemble score on the same weights at 1e-5 (float32, the plain version of
the kernel on the CPU).  Fixtures are written with torch in the format of
the reference's checkpoints, their config an ``easydict.EasyDict`` stand-in
registered for the write only.
"""

import collections
import pickle
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tsdiff_tpu.data import convert as jconvert
from tsdiff_tpu.data.torch_reader import load_torch_file as jax_load_torch_file
from tsdiff_tpu.diffusion.ensemble import make_packed_ensemble_eps_fn as jax_ensemble
from tsdiff_tpu.diffusion.ensemble import stack_params as jax_stack

from tsdiff_tpu_torch.data import convert
from tsdiff_tpu_torch.data.synthetic import make_corpus
from tsdiff_tpu_torch.data.torch_reader import _Placeholder, load_torch_file
from tsdiff_tpu_torch.diffusion.ensemble import load_members, make_packed_ensemble_eps_fn
from tsdiff_tpu_torch.train import load_checkpoint

from test_condensenc import MODEL_CFG
from test_torch_common import close, small_setup


def _easydict(obj, cls):
    if isinstance(obj, dict):
        return cls({k: _easydict(v, cls) for k, v in obj.items()})
    return obj


def write_reference_pt(path: str, config: dict, params, iteration: int = 1000,
                       avg_val_loss: float = 0.25) -> None:
    """A reference ``<iter>.pt`` (``torch.save`` zip container): the state
    dict of ``params`` with the schedule buffers, the config as nested
    ``easydict.EasyDict``."""
    mod = types.ModuleType("easydict")
    mod.EasyDict = type("EasyDict", (dict,), {"__module__": "easydict"})
    sd = collections.OrderedDict(
        (k, torch.from_numpy(np.array(v))) for k, v in
        convert.condensenc_state_dict_from_params(
            jax.device_get(params), config["model"]["encoder"]["num_convs"]).items())
    n = config["model"]["num_diffusion_timesteps"]
    sd["betas"] = torch.linspace(1e-7, 2e-3, n, dtype=torch.float64)
    sd["alphas"] = torch.cumprod(1 - sd["betas"], 0)
    saved = sys.modules.get("easydict")
    sys.modules["easydict"] = mod
    try:
        torch.save({"config": _easydict(config, mod.EasyDict), "model": sd,
                    "iteration": iteration, "avg_val_loss": avg_val_loss}, path)
    finally:
        if saved is None:
            del sys.modules["easydict"]
        else:
            sys.modules["easydict"] = saved


def reference_config(model_cfg=MODEL_CFG) -> dict:
    return {"model": model_cfg.to_dict(), "train": {"seed": 2021}}


def tensors():
    g = torch.Generator().manual_seed(0)
    base = torch.arange(48, dtype=torch.float32)
    return {
        "f32": torch.randn(3, 5, generator=g),
        "f64": torch.randn(4, 2, generator=g, dtype=torch.float64),
        "bf16": torch.randn(6, generator=g).to(torch.bfloat16),
        "int64": torch.arange(-5, 7),
        "bool": torch.tensor([True, False, True, True]),
        "view_offset": base[5:17].reshape(3, 4),
        "view_strided": base.reshape(6, 8)[1:5:2, ::3],
        "transposed": torch.randn(4, 6, generator=g).t(),
    }


@pytest.mark.parametrize("name", list(tensors()))
def test_load_torch_file_equals_jax_bit_for_bit(tmp_path, name):
    obj = tensors()
    path = str(tmp_path / "t.pt")
    torch.save({"x": obj[name], "shared_base": obj["view_offset"]}, path)
    got, want = load_torch_file(path)["x"], jax_load_torch_file(path)["x"]
    assert got.dtype == want.dtype and got.shape == want.shape == tuple(obj[name].shape)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    np.testing.assert_array_equal(got, obj[name].float().numpy() if name == "bf16"
                                  else obj[name].numpy())


def test_foreign_global_unpickles_to_a_placeholder(tmp_path):
    path = str(tmp_path / "opt.pt")
    lin = torch.nn.Linear(3, 3)
    torch.save({"w": lin.weight.detach(), "cls": torch.nn.Linear, "dtype": torch.float32}, path)
    out = load_torch_file(path)
    np.testing.assert_array_equal(out["w"], lin.weight.detach().numpy())
    for key, name in (("cls", "torch.nn.modules.linear.Linear"), ("dtype", "torch.float32")):
        assert issubclass(out[key], _Placeholder) and out[key]._qualname == name


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def test_convert_reference_checkpoint_equals_jax(tmp_path):
    _, (params,), *_ = small_setup(seed=21)
    pt = str(tmp_path / "1000.pt")
    write_reference_pt(pt, reference_config(), params, iteration=1000)
    got, want = convert.convert_reference_checkpoint(pt), jconvert.convert_reference_checkpoint(pt)
    assert set(got) == set(want)
    for key in set(got) - {"params"}:
        assert got[key] == want[key], key
    gl, wl = dict(leaves(got["params"])), dict(leaves(want["params"]))
    assert set(gl) == set(wl)
    for path_, v in gl.items():
        assert v.dtype == wl[path_].dtype
        np.testing.assert_array_equal(v, wl[path_], err_msg=str(path_))
    # and equal to the weights the file was made from
    for path_, v in dict(leaves(jax.device_get(params))).items():
        np.testing.assert_array_equal(gl[path_], v)


def test_load_checkpoint_reads_a_pt_and_the_model_scores_as_jax(tmp_path):
    """``load_checkpoint`` detects the zip container; two members loaded
    from ``.pt`` files score as JAX's packed ensemble on the same weights."""
    jmodel, params, jb, _, tb, _ = small_setup(seed=22, members=2)
    pts = []
    for m, p in enumerate(params):
        pts.append(str(tmp_path / f"m{m}.pt"))
        write_reference_pt(pts[-1], reference_config(), p, iteration=10 + m)
    ck = load_checkpoint(pts[1])
    assert ck["format"] == "tsdiff_tpu.ckpt.v1" and ck["iteration"] == 11
    members, _ = load_members(pts, "cpu", torch.float32, fused_score=True)
    pos = np.asarray(jax.random.normal(jax.random.key(5), jb.pos.shape)) * 1.5
    pos = (pos * np.asarray(jb.node_mask)[..., None]).astype(np.float32)
    ref = jax_ensemble(jmodel, jax_stack(params), jb)(jnp.asarray(pos))
    out = make_packed_ensemble_eps_fn(members, tb)(torch.from_numpy(pos))
    close(out, ref, rtol=1e-5, atol=1e-5)


def test_dualenc_pt_raises(tmp_path):
    """A dual-encoder ``.pt`` converts (``tests/test_torch_legacy_model.py``
    loads one and scores it against JAX); one whose weights are not the dual
    encoder's (here the condensed encoder's) raises, in the port as in JAX."""
    _, (params,), *_ = small_setup(seed=23)
    pt = str(tmp_path / "dual.pt")
    cfg = {**MODEL_CFG.to_dict(), "network": "dualenc", "num_convs": 2, "num_convs_local": 2}
    write_reference_pt(pt, {"model": cfg}, params)
    with pytest.raises(KeyError, match="edge_encoder_global"):
        load_checkpoint(pt)
    with pytest.raises(KeyError):
        jconvert.convert_reference_checkpoint(pt)


@pytest.mark.parametrize("cmd", ["ckpt", "dataset"])
def test_convert_cli_writes_jax_files(tmp_path, capsys, cmd):
    from test_torch_pyg import write_pyg_pickle

    src = str(tmp_path / ("in.pt" if cmd == "ckpt" else "in.pkl"))
    if cmd == "ckpt":
        _, (params,), *_ = small_setup(seed=24)
        write_reference_pt(src, reference_config(), params)
    else:
        write_pyg_pickle(src, make_corpus(3, seed=24))
    jconvert.main([cmd, src, str(tmp_path / "jax.out")])
    jprinted = capsys.readouterr().out
    convert.main([cmd, src, str(tmp_path / "port.out")])
    printed = capsys.readouterr().out
    assert printed.replace("port.out", "jax.out") == jprinted
    with open(tmp_path / "port.out", "rb") as f:
        got = pickle.load(f)
    with open(tmp_path / "jax.out", "rb") as f:
        want = pickle.load(f)
    if cmd == "dataset":
        got, want = got["graphs"], want["graphs"]
        assert len(got) == len(want) == 3
    else:
        got, want = [got], [want]
    for g, w in zip(got, want):
        gl, wl = dict(leaves(g)), dict(leaves(w))
        assert set(gl) == set(wl)
        for k, v in gl.items():
            if isinstance(v, np.ndarray):
                assert v.dtype == wl[k].dtype
                np.testing.assert_array_equal(v, wl[k], err_msg=str(k))
            else:
                assert v == wl[k], k


def test_service_serves_from_reference_pt(tmp_path):
    """``SamplerService`` takes ``.pt`` members as they come: a round equals
    the round of the same weights from ``.ckpt`` files, bit for bit."""
    from tsdiff_tpu_torch.core.graph import from_numpy_graphs
    from tsdiff_tpu_torch.serve import SamplerService

    _, params, _, _, _, graphs = small_setup(seed=25, sizes=(5, 7, 6), members=2)
    files = {"pt": [], "ckpt": []}
    for m, p in enumerate(params):
        files["pt"].append(str(tmp_path / f"m{m}.pt"))
        write_reference_pt(files["pt"][-1], reference_config(), p)
        files["ckpt"].append(str(tmp_path / f"m{m}.ckpt"))
        with open(files["ckpt"][-1], "wb") as f:
            pickle.dump({"format": "tsdiff_tpu.ckpt.v1", "config": reference_config(),
                         "params": jax.device_get(p), "ema_params": None}, f)
    batch = from_numpy_graphs(graphs + graphs[-1:], max_nodes=12)
    out = {}
    for fmt, paths in files.items():
        svc = SamplerService(paths, n_steps=6, dtype="float32", fused_score=True, max_batch=4,
                             device="cpu", capture=False)
        try:
            out[fmt] = svc._execute(12, 4, batch, 0)
        finally:
            svc.close()
    (pos, nan), (ref, ref_nan) = out["pt"], out["ckpt"]
    assert not nan and not ref_nan and np.isfinite(pos).all()
    np.testing.assert_array_equal(pos, ref)
