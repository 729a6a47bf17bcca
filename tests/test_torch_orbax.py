"""Orbax checkpoint directories between the port and the JAX package.

The port reads orbax directories (``tsdiff_tpu_torch/train/orbax_io.py``)
without JAX, orbax or tensorstore: the OCDBT layout orbax writes by default
(what the JAX package's ``--ckpt_backend orbax`` writes) and the per-leaf
layout; it writes the per-leaf layout, uncompressed.  Held here:

* what the JAX package writes loads through the port leaf by leaf and bit
  for bit as through the JAX package (f32 and bf16 trees, with and without
  EMA, an optax chain of 12 states), and what the port writes loads through
  the JAX package (and orbax) to the port's arrays;
* the port's OCDBT key -> bytes map equals tensorstore's over databases
  with out-of-line values, multi-chunk arrays, interior B-tree nodes,
  version-tree nodes, no compression and a zstd level (numbered manifests,
  which orbax does not write, raise);
  zarr v2 arrays of every dtype orbax writes, through the port as through
  orbax; a corrupted CRC and a missing chunk raise;
* the committed fixture ``tests/torch_data/orbax_jax_small/`` (written by
  the JAX package, see ``write_jax_fixture``) equals its ``.npz``, read in a
  process where jax, orbax and tensorstore cannot be imported, and equals
  what the JAX package writes today;
* the save copies the state before it returns; a failed write raises at
  ``wait_for_saves``;
* the train CLIs resume from the other package's ``.orbax`` as from the
  matching ``.ckpt`` (float32 at rtol=5e-4, atol=5e-5, as
  ``test_torch_opt_state.py``), and the sampling CLI gives the same samples
  from ``.orbax`` members as from ``.ckpt`` members, bit for bit.
"""

import dataclasses
import glob
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch

from tsdiff_tpu.config import Config as JConfig
from tsdiff_tpu.models import get_model as jax_get_model
from tsdiff_tpu.train import make_optimizer as jax_make_optimizer
from tsdiff_tpu.train.orbax_io import load_checkpoint_orbax as jax_load_orbax
from tsdiff_tpu.train.orbax_io import save_checkpoint_orbax as jax_save_orbax
from tsdiff_tpu.train.orbax_io import wait_for_saves as jax_wait_for_saves
from tsdiff_tpu.train.trainer import TrainState as JTrainState
from tsdiff_tpu.train.trainer import load_checkpoint as jax_load_checkpoint
from tsdiff_tpu.train.trainer import restore_opt_state

from tsdiff_tpu_torch.config import Config
from tsdiff_tpu_torch.train import (
    get_checkpoint_path,
    init_train_state,
    load_checkpoint,
    make_optimizer,
    opt_state_from_checkpoint,
    save_checkpoint,
)
from tsdiff_tpu_torch.train import orbax_io

from orbax_leaves import bits, fixture_arrays, is_empty, leaves
from test_condensenc import MODEL_CFG, make_batch
from test_torch_dense_model import port_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "torch_data", "orbax_jax_small")
CFG = JConfig({**MODEL_CFG.to_dict(), "feat_dim": 10, "hidden_dim": 24,
               "encoder": {**MODEL_CFG.encoder.to_dict(), "hidden_dim": 24}})
#: the committed fixture's model: narrow, so that the fixture stays small
FIXTURE_CFG = JConfig({**MODEL_CFG.to_dict(), "feat_dim": 4, "hidden_dim": 8,
                       "encoder": {**MODEL_CFG.encoder.to_dict(), "hidden_dim": 8}})
LR, MAX_NORM = 5e-4, 3000.0


def optimizer_cfg(weight_decay: float) -> dict:
    return dict(type="adam", lr=LR, beta1=0.95, beta2=0.999, weight_decay=weight_decay)


def assert_trees_bitwise_equal(got, want):
    """Same structure (dict keys, sequence lengths, empty values) and every
    array leaf equal in dtype, shape and bits."""
    g, w = dict(leaves(got)), dict(leaves(want))
    assert set(g) == set(w)
    for path in w:
        a, b = g[path], w[path]
        if is_empty(b):
            assert a == b and type(a) is type(b), path
            continue
        x, y = bits(a), bits(b)
        assert x.dtype == y.dtype and x.shape == y.shape, (path, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=str(path))


def jax_state(seed: int, weight_decay: float, ema: bool, dtype=jnp.float32, chain: int = 0,
              cfg=CFG):
    """A JAX train state of ``cfg`` (``dtype`` params) with random moments
    and count 7; ``chain`` > 0 prepends that many ``optax.identity`` states
    to the optimizer chain (so Adam's state sits at index ``chain + 1``)."""
    rng = np.random.default_rng(seed)
    batch = make_batch(rng, [5, 7], n_pad=8, feat_dim=cfg.feat_dim)
    model = jax_get_model(cfg)
    params = model.init(jax.random.key(seed), batch.atom_type, batch.r_feat, batch.p_feat,
                        batch.pos, batch.bond_mat, batch.node_mask)
    params = jax.tree_util.tree_map(lambda x: x.astype(dtype), params)
    tx = jax_make_optimizer(JConfig(optimizer_cfg(weight_decay)), MAX_NORM)
    if chain:   # one flat chain: the identities, then the clip and Adam
        tx = optax.chain(*[optax.identity() for _ in range(chain)],
                         optax.clip_by_global_norm(MAX_NORM), optax.scale_by_adam(0.95, 0.999))
    opt = tx.init(params)
    opt = jax.tree_util.tree_map(
        lambda x: (jnp.asarray(rng.normal(size=x.shape), x.dtype)
                   if jnp.issubdtype(x.dtype, jnp.floating) else jnp.full_like(x, 7)), opt)
    ema_params = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), params) if ema else None
    return JTrainState(params=params, opt_state=opt, step=jnp.asarray(7, jnp.int32),
                       ema_params=ema_params), tx


def full_config(weight_decay: float, cfg=CFG) -> dict:
    return {"model": cfg.to_dict(), "train": {"optimizer": optimizer_cfg(weight_decay)}}


def write_jax_fixture(root: str) -> str:
    """The committed fixture: the JAX package's ``save_checkpoint_orbax`` of
    ``jax_state(11, 0.01, ema=True)`` of ``FIXTURE_CFG`` (f32 params, a bf16
    EMA, the 3-state chain of Adam with weight decay) as ``<root>/7.orbax`` with its meta
    file, and ``<root>/7.npz``: every leaf of the JAX package's
    ``load_checkpoint_orbax`` keyed by its path joined with ``/`` (bf16 as
    uint16 bits; the empty states hold no array).  Regenerate with
    ``python -c "import sys; sys.path[:0] = ['tests']; import
    test_torch_orbax as t; t.write_jax_fixture(t.FIXTURE)"`` (after removing
    the old files)."""
    os.makedirs(root, exist_ok=True)
    state, _ = jax_state(11, 0.01, ema=True, cfg=FIXTURE_CFG)
    path = os.path.join(root, "7.orbax")
    jax_save_orbax(path, JConfig(full_config(0.01, FIXTURE_CFG)), jax.device_get(state), {"lr": LR},
                   iteration=7, avg_val_loss=2.5)
    jax_wait_for_saves()
    np.savez(os.path.join(root, "7.npz"), **fixture_arrays(jax_load_orbax(path)))
    return path


# -- JAX writes, the port reads ------------------------------------------------

@pytest.mark.parametrize("case", ["f32", "bf16_ema", "chain12"])
def test_jax_written_orbax_loads_in_port(tmp_path, case):
    """The port's ``load_checkpoint`` of the JAX package's orbax directory
    equals the JAX package's ``load_checkpoint_orbax`` in every field and
    every leaf, bit for bit; the port resumes the Adam state that was saved,
    each moment on its parameter.  (The JAX package's own
    ``restore_opt_state`` cannot take this directory back: orbax restores
    optax's ``EmptyState`` as a None leaf, one leaf more than the template
    holds; ROADMAP §C.7.)"""
    weight_decay = 0.01 if case == "bf16_ema" else 0.0
    state, tx = jax_state(3, weight_decay, ema=case == "bf16_ema",
                          dtype=jnp.bfloat16 if case == "bf16_ema" else jnp.float32,
                          chain=10 if case == "chain12" else 0)
    path = str(tmp_path / "7.orbax")
    jax_save_orbax(path, JConfig(full_config(weight_decay)), jax.device_get(state), {"lr": LR},
                   iteration=7, avg_val_loss=2.5)
    jax_wait_for_saves()
    want = jax_load_orbax(path)
    got = load_checkpoint(path)
    assert set(got) == set(want)
    for key in ("format", "config", "scheduler", "iteration", "avg_val_loss"):
        assert got[key] == want[key], key
    for key in ("params", "opt_state", "ema_params"):
        assert_trees_bitwise_equal(got[key], want[key])
    assert len(got["opt_state"]) == (12 if case == "chain12" else 3 if weight_decay else 2)
    adam = jax.device_get(state.opt_state[-1] if case == "chain12" else state.opt_state[1])
    opt = opt_state_from_checkpoint(got, "cpu")
    from tsdiff_tpu_torch.convert import params_from_jax

    assert opt["count"] == int(adam.count) == 7
    for m in ("mu", "nu"):
        ref = params_from_jax(getattr(adam, m))
        assert set(ref) == set(opt[m])
        for name, v in opt[m].items():
            assert torch.equal(v, ref[name]), (m, name)


def test_opt_state_from_orbax_dicts_orders_chain_entries_by_number():
    """Older orbax versions restore a tuple as a dict keyed "0", "1", ...: a
    12-state chain whose Adam state is entry 11 ("11" sorts before "2" as a
    string) resumes the same as the list."""
    adam = {"count": np.asarray(5, np.int32),
            "mu": {"params": {"atom_embedding": {"embedding": np.ones((3, 2), np.float32)}}},
            "nu": {"params": {"atom_embedding": {"embedding": np.full((3, 2), 2, np.float32)}}}}
    decoy = {"count": np.asarray(9, np.int32), "mu": {}, "nu": {}}
    as_list = [None] * 2 + [decoy] + [None] * 8 + [adam]
    as_dict = {str(i): v for i, v in enumerate(as_list)}
    for opt in (as_list, as_dict):
        got = opt_state_from_checkpoint({"opt_state": opt}, "cpu")
        assert got["count"] == 9   # the first Adam-shaped entry, in numeric order
    as_dict.pop("2")
    got = opt_state_from_checkpoint({"opt_state": as_dict}, "cpu")
    assert got["count"] == 5 and float(got["nu"]["atom_embedding.weight"][0, 0]) == 2.0


# -- the port writes, JAX reads ------------------------------------------------

def port_state(weight_decay: float, seed: int = 1):
    """A port train state of ``CFG`` with random moments, count 7 and EMA."""
    state, _ = jax_state(seed, weight_decay, ema=False)
    model = port_model(jax.device_get(state.params), cfg=CFG)
    tx = make_optimizer(Config(optimizer_cfg(weight_decay)), MAX_NORM)
    tstate = init_train_state(model, tx, ema_decay=0.999)
    rng = np.random.default_rng(seed + 1)
    with torch.no_grad():
        for m in ("mu", "nu"):
            for v in tstate.opt_state[m].values():
                v.copy_(torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32)))
        for v in tstate.ema_params.values():
            v.add_(torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32)))
    tstate.opt_state["count"] = torch.tensor(7, dtype=torch.int32)
    tstate.step = torch.tensor(7, dtype=torch.int32)
    return tstate, state


@pytest.mark.parametrize("weight_decay", [0.0, 0.01], ids=["adam", "weight_decay"])
def test_port_written_orbax_loads_in_jax(tmp_path, weight_decay):
    """The port's ``save_checkpoint_orbax`` (uncompressed, one directory per
    leaf) read by the JAX package's ``load_checkpoint_orbax``: the same
    payload as the port's ``.ckpt`` of the same state, bit for bit, and the
    moments restored by ``restore_opt_state`` into JAX's optimizer
    template; orbax's own restore reads it too."""
    tstate, jstate = port_state(weight_decay)
    config = Config(full_config(weight_decay))
    path = str(tmp_path / "7.orbax")
    orbax_io.save_checkpoint_orbax(path, config, tstate, {"lr": LR}, iteration=7,
                                   avg_val_loss=2.5)
    orbax_io.wait_for_saves()
    save_checkpoint(str(tmp_path / "7.ckpt"), config, tstate, {"lr": LR}, iteration=7,
                    avg_val_loss=2.5)
    pickled = jax_load_checkpoint(str(tmp_path / "7.ckpt"))
    got = jax_load_orbax(path)
    with open(os.path.join(path, "_METADATA")) as f:
        assert json.load(f)["use_ocdbt"] is False
    assert not glob.glob(os.path.join(path, "*", ".zarray")) == []
    for key in ("config", "scheduler", "iteration", "avg_val_loss"):
        assert got[key] == pickled[key], key
    for key in ("params", "ema_params"):
        assert_trees_bitwise_equal(got[key], pickled[key])
    assert_trees_bitwise_equal(got["opt_state"], list(pickled["opt_state"]))
    assert got["opt_state"][0] == ()   # optax's EmptyState, as the pickle holds it
    jtx = jax_make_optimizer(JConfig(optimizer_cfg(weight_decay)), MAX_NORM)
    template = jtx.init(jstate.params)
    restored = restore_opt_state(template, got["opt_state"])
    assert len(restored) == len(template) and int(restored[1].count) == 7
    for m in ("mu", "nu"):
        assert_trees_bitwise_equal(jax.device_get(getattr(restored[1], m)),
                                   pickled["opt_state"][1][m])
    with ocp.StandardCheckpointer() as cp:
        raw = cp.restore(path)
    assert_trees_bitwise_equal(raw["params"], pickled["params"])
    # and the port reads its own directory as it reads the pickle
    assert_trees_bitwise_equal(load_checkpoint(path)["params"], pickled["params"])


def test_port_writes_orbax_leaf_layout(tmp_path):
    """Every dtype the writer takes, a 0-dim array, a Python scalar and the
    empty values, restored by orbax as they were written and read back
    by the port the same."""
    tree = {"a": {"f4": np.arange(6, dtype=np.float32).reshape(2, 3),
                  "f8": np.linspace(0, 1, 4), "i4": np.arange(3, dtype=np.int32),
                  "i8": np.arange(-2, 2, dtype=np.int64), "u1": np.arange(5, dtype=np.uint8),
                  "b1": np.array([True, False, True]), "s": np.asarray(2.5, np.float32),
                  "bf": torch.tensor([1.5, -2.0, 3.25], dtype=torch.bfloat16)},
            "seq": [None, (), {}, [], np.float64(3.0)], "n": 7}
    path = str(tmp_path / "leaves")
    orbax_io.write_tree(path, tree)
    with ocp.StandardCheckpointer() as cp:
        raw = cp.restore(path)
    got = orbax_io.read_tree(path)
    assert_trees_bitwise_equal(got, raw)
    want = {**tree, "seq": list(tree["seq"])}
    assert_trees_bitwise_equal(got, want)
    assert got["n"] == 7 and isinstance(got["n"], int)
    assert json.load(open(os.path.join(path, "a.bf", ".zarray")))["dtype"] == "bfloat16"
    with pytest.raises(ValueError, match="size 0"):
        orbax_io.write_tree(str(tmp_path / "empty"), {"x": np.zeros((0, 3), np.float32)})


# -- OCDBT and zarr against tensorstore and orbax --------------------------------

def ocdbt_db(root: str, config: dict | None, commits: list[dict]) -> str:
    spec = {"driver": "ocdbt", "base": f"file://{root}/"}
    if config is not None:
        spec["config"] = config
    kv = ts.KvStore.open(spec).result()
    for commit in commits:
        txn = ts.Transaction()
        for k, v in commit.items():
            kv.with_transaction(txn).write(k, v).result()
        txn.commit_async().result()
    return root


def tensorstore_items(root: str) -> dict:
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/"}).result()
    return {bytes(k): bytes(kv.read(k).result().value) for k in kv.list().result()}


def _orbax_checkpoint(root):
    rng = np.random.default_rng(0)
    with ocp.StandardCheckpointer() as cp:
        cp.save(root, {"small": np.arange(6, dtype=np.float32),
                       "big": rng.normal(size=(64, 64)).astype(np.float32)})
    return root


def _zarr_multichunk(root):
    spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{root}/"},
            "path": "x", "metadata": {"dtype": "<f4", "shape": [37, 23], "chunks": [8, 5],
                                      "compressor": {"id": "zstd", "level": 3}}}
    arr = ts.open(spec, create=True).result()
    arr.write(np.arange(37 * 23, dtype=np.float32).reshape(37, 23)).result()
    return root


DATABASES = {
    # orbax's own layout: the root tree points into ocdbt.process_0/d/, the
    # 64x64 array's chunk stored out of line
    "orbax_out_of_line": _orbax_checkpoint,
    "zarr_multichunk": _zarr_multichunk,
    "indirect_values": lambda r: ocdbt_db(r, {"max_inline_value_bytes": 4},
                                          [{f"k{i:02d}": bytes([i]) * (10 + i) for i in range(6)}]),
    "interior_nodes": lambda r: ocdbt_db(r, {"max_decoded_node_bytes": 256}, [
        {f"key/{i:04d}/{'x' * (i % 7)}": bytes(range(i % 40)) for i in range(300)}]),
    "version_tree": lambda r: ocdbt_db(r, {"version_tree_arity_log2": 2},
                                       [{f"v{i}": b"a" * i} for i in range(1, 40)]),
    "uncompressed": lambda r: ocdbt_db(r, {"compression": None},
                                       [{"a": b"hello", "b": b"x" * 2000}]),
    "zstd_level": lambda r: ocdbt_db(r, {"compression": {"id": "zstd", "level": 5}},
                                     [{"a": b"y" * 3000, "b": b""}, {"c": b"z"}]),
}


@pytest.mark.parametrize("name", sorted(DATABASES))
def test_ocdbt_key_map_equals_tensorstore(tmp_path, name):
    root = DATABASES[name](str(tmp_path / name))
    reader = orbax_io.OcdbtReader(root)
    assert reader.items() == tensorstore_items(root)
    if name == "version_tree":
        # 39 commits after the empty tree: older versions in version-tree nodes
        assert reader.version_nodes
        gens = sorted(v["generation"] for ref in reader.version_nodes
                      for v in reader.version_tree(ref))
        gens += sorted(v["generation"] for v in reader.versions)
        assert gens == list(range(1, 41))
    if name == "zstd_level":
        assert reader.config["compression"] == {"id": "zstd", "level": 5}
    if name == "uncompressed":
        assert reader.config["compression"] is None
    if name == "zarr_multichunk":
        items = reader.items()
        got = orbax_io.read_zarr_array(lambda k: items.get(k.encode()), "x")
        want = ts.open({"driver": "zarr", "path": "x", "kvstore": {
            "driver": "ocdbt", "base": f"file://{root}/"}}).result().read().result()
        np.testing.assert_array_equal(got, want)
        assert sum(k.startswith(b"x/") and not k.endswith(b".zarray") for k in items) == 5 * 5


@pytest.mark.parametrize("use_ocdbt", [True, False], ids=["ocdbt", "per_leaf"])
def test_read_tree_equals_orbax_restore(tmp_path, use_ocdbt):
    """Every dtype orbax writes (zstd-compressed), 0-dim arrays, a Python
    scalar and the empty values, through the port as through orbax."""
    tree = {"f4": np.arange(12, dtype=np.float32).reshape(3, 4), "f8": np.linspace(0, 1, 5),
            "i4": np.arange(3, dtype=np.int32), "i8": np.arange(-3, 3, dtype=np.int64),
            "u1": np.arange(7, dtype=np.uint8), "b1": np.array([True, False]),
            "bf": jnp.asarray([1.5, -2.0, 0.1], jnp.bfloat16), "zero_dim": np.asarray(3, np.int32),
            "scalar": 2.5, "chain": ((), {"count": np.asarray(4, np.int32)}, None),
            "empty": {}}
    path = str(tmp_path / "ckpt")
    handler = ocp.StandardCheckpointHandler(use_ocdbt=use_ocdbt)
    with ocp.Checkpointer(handler) as cp:
        cp.save(path, args=ocp.args.StandardSave(tree))
    with ocp.StandardCheckpointer() as cp:
        want = cp.restore(path)
    got = orbax_io.read_tree(path)
    assert_trees_bitwise_equal(got, want)
    assert got["scalar"] == 2.5 and got["chain"][2] is None and got["chain"][0] == ()


def test_numbered_manifest_raises(tmp_path):
    root = ocdbt_db(str(tmp_path / "n"), {"manifest_kind": "numbered"}, [{"a": b"v"}])
    with pytest.raises(ValueError, match="manifest kind 1"):
        orbax_io.OcdbtReader(root)


def test_corrupted_crc_raises(tmp_path):
    root = _orbax_checkpoint(str(tmp_path / "c"))
    node = os.path.join(root, "manifest.ocdbt")
    blob = bytearray(open(node, "rb").read())
    blob[-1] ^= 0x01
    open(node, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="CRC-32C mismatch"):
        orbax_io.OcdbtReader(root)


def test_corrupted_node_raises(tmp_path):
    root = _orbax_checkpoint(str(tmp_path / "c"))
    reader = orbax_io.OcdbtReader(root)
    path, offset, length = reader.latest["root"]
    with open(os.path.join(root, path), "r+b") as f:
        f.seek(offset + length // 2)
        b = f.read(1)
        f.seek(offset + length // 2)
        f.write(bytes([b[0] ^ 0x40]))
    with pytest.raises(ValueError, match="CRC-32C mismatch"):
        orbax_io.OcdbtReader(root).items()


def test_missing_chunk_raises(tmp_path):
    path = str(tmp_path / "t")
    orbax_io.write_tree(path, {"x": np.ones((2, 2), np.float32)})
    os.remove(os.path.join(path, "x", "0.0"))
    with pytest.raises(KeyError, match="chunk x/0.0 is missing"):
        orbax_io.read_tree(path)


def test_missing_zstd_library_raises_naming_it(monkeypatch):
    monkeypatch.setattr(orbax_io, "_zstd", None)
    monkeypatch.setattr(orbax_io.ctypes.util, "find_library", lambda name: "libzstd-absent.so.9")
    with pytest.raises(OSError, match=r"libzstd \(libzstd-absent\.so\.9\) cannot be loaded"):
        orbax_io.zstd_decompress(b"\x28\xb5\x2f\xfd")


def test_zstd_decoder_against_tensorstore_frames(tmp_path):
    """Frames with and without their content size (tensorstore's nodes and
    zarr chunks), decoded by the port's libzstd binding."""
    root = _orbax_checkpoint(str(tmp_path / "c"))
    items = orbax_io.OcdbtReader(root).items()
    with ocp.StandardCheckpointer() as cp:
        big = cp.restore(root)["big"]
    got = np.frombuffer(orbax_io.zstd_decompress(items[b"big/0.0"], big.nbytes), np.float32)
    np.testing.assert_array_equal(got.reshape(big.shape), big)
    assert "libzstd" in orbax_io.zstd_library
    with pytest.raises(ValueError, match="expected 7"):
        orbax_io.zstd_decompress(items[b"big/0.0"], 7)


# -- the committed fixture --------------------------------------------------------

def test_fixture_reads_without_jax_orbax_or_tensorstore():
    """The JAX-written fixture (OCDBT, zstd) loads through the port's
    ``load_checkpoint`` in a process where jax, orbax and tensorstore cannot
    be imported, every leaf equal to the committed ``.npz``."""
    code = f"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "orbax.checkpoint", "tensorstore",
             "ml_dtypes"):
    sys.modules[name] = None
sys.path[:0] = [{REPO!r}, {os.path.join(REPO, "tests")!r}]
import numpy as np
from tsdiff_tpu_torch.train import load_checkpoint
from tsdiff_tpu_torch.train import orbax_io
from orbax_leaves import fixture_arrays
ck = load_checkpoint({os.path.join(FIXTURE, "7.orbax")!r})
want = np.load({os.path.join(FIXTURE, "7.npz")!r})
got = fixture_arrays(ck)
assert set(got) == set(want.files), sorted(set(got) ^ set(want.files))
for k in want.files:
    assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
with open({os.path.join(FIXTURE, "7.orbax", "_METADATA")!r}) as f:
    assert '"use_ocdbt": true' in f.read()
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and m.split(".")[0] in ("jax", "orbax", "tensorstore", "tsdiff_tpu"))
assert not bad, bad
print(len(want.files), ck["iteration"], orbax_io.zstd_library)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    n, it, lib = out.stdout.split(" ", 2)
    assert int(n) > 50 and int(it) == 7 and "libzstd" in lib


def test_fixture_equals_what_the_jax_package_writes(tmp_path):
    """``write_jax_fixture`` run now gives the committed fixture's leaves (the
    directories differ in their random names and timestamps only)."""
    fresh = write_jax_fixture(str(tmp_path / "fixture"))
    committed = load_checkpoint(os.path.join(FIXTURE, "7.orbax"))
    now = load_checkpoint(fresh)
    for key in ("params", "opt_state", "ema_params"):
        assert_trees_bitwise_equal(now[key], committed[key])
    for key in ("config", "scheduler", "iteration", "avg_val_loss"):
        assert now[key] == committed[key]
    want, got = np.load(os.path.join(FIXTURE, "7.npz")), np.load(str(tmp_path / "fixture" / "7.npz"))
    assert set(want.files) == set(got.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k])
    size = sum(os.path.getsize(p) for p in glob.glob(os.path.join(FIXTURE, "**"), recursive=True)
               if os.path.isfile(p))
    assert size < 200_000


# -- the save --------------------------------------------------------------------

def test_save_snapshots_the_state_before_it_returns(tmp_path):
    """Tensors changed in place right after ``save`` returns: the directory
    written holds the values from before the change."""
    tstate, _ = port_state(0.0)
    config = Config(full_config(0.0))
    save_checkpoint(str(tmp_path / "before.ckpt"), config, tstate, iteration=7)
    writer = orbax_io.OrbaxWriter()
    writer.save(str(tmp_path / "7.orbax"), config, tstate, iteration=7)
    with torch.no_grad():
        for v in list(tstate.params.values()) + list(tstate.ema_params.values()):
            v.add_(1.0)
        for m in ("mu", "nu"):
            for v in tstate.opt_state[m].values():
                v.mul_(-3.0)
        tstate.opt_state["count"].fill_(99)
    writer.wait()
    assert writer.finished and writer.finished[0][0] == str(tmp_path / "7.orbax")
    got, want = load_checkpoint(str(tmp_path / "7.orbax")), load_checkpoint(
        str(tmp_path / "before.ckpt"))
    for key in ("params", "ema_params"):
        assert_trees_bitwise_equal(got[key], want[key])
    assert_trees_bitwise_equal(got["opt_state"], list(want["opt_state"]))
    # a save over an existing directory replaces it whole, and leaves no
    # temporary directory behind
    writer.save(str(tmp_path / "7.orbax"), config, tstate, iteration=7)
    writer.wait()
    assert int(load_checkpoint(str(tmp_path / "7.orbax"))["opt_state"][1]["count"]) == 99
    assert sorted(os.listdir(tmp_path)) == ["7.orbax", "7.orbax.meta.json", "before.ckpt"]


def test_failed_write_raises_at_wait_and_leaves_nothing(tmp_path):
    tstate, _ = port_state(0.0)
    name = next(iter(tstate.params))
    tstate.params[name] = torch.zeros((0, 3))   # orbax does not save arrays of size 0
    writer = orbax_io.OrbaxWriter()
    writer.save(str(tmp_path / "3.orbax"), Config(full_config(0.0)), tstate, iteration=3)
    with pytest.raises(ValueError, match="size 0"):
        writer.wait()
    writer.wait()   # raised once, not again
    assert sorted(os.listdir(tmp_path)) == ["3.orbax.meta.json"]
    with pytest.raises(FileNotFoundError):
        get_checkpoint_path(str(tmp_path))


def test_checkpoint_discovery_takes_orbax_directories(tmp_path):
    for name in ("5.ckpt", "9.orbax.meta.json", "12.orbax.orbax-checkpoint-tmp-1"):
        open(tmp_path / name, "w").close()
    os.makedirs(tmp_path / "9.orbax")
    os.makedirs(tmp_path / "12.orbax.orbax-checkpoint-tmp-2")
    assert get_checkpoint_path(str(tmp_path)) == (str(tmp_path / "9.orbax"), 9)
    assert get_checkpoint_path(str(tmp_path), it=5) == (str(tmp_path / "5.ckpt"), 5)


def test_write_checkpoint_orbax_converts_an_exported_member(tmp_path):
    """A params-only payload (a campaign member: no optimizer state, no
    EMA) written through the writer loads back to the same payload."""
    state, _ = jax_state(5, 0.0, ema=False)
    payload = {"format": "tsdiff_tpu.ckpt.v1", "config": {"model": CFG.to_dict()},
               "params": jax.device_get(state.params), "opt_state": None, "ema_params": None,
               "scheduler": None, "iteration": 140000, "avg_val_loss": None}
    path = str(tmp_path / "member.orbax")
    orbax_io.write_checkpoint_orbax(path, payload)
    got = load_checkpoint(path)
    assert got["opt_state"] is None and got["ema_params"] is None
    assert got["iteration"] == 140000 and got["config"] == payload["config"]
    assert_trees_bitwise_equal(got["params"], payload["params"])
    assert jax_load_orbax(path)["opt_state"] is None


# -- the CLIs ----------------------------------------------------------------------

def cli_config(root: str, max_iters: int) -> str:
    """``tests/test_torch_train.py``'s tiny config without the fused stack,
    as ``cfg.yml`` (both CLIs read YAML, and a JAX CLI resume looks for a
    ``.yml`` in the run directory)."""
    import yaml

    from test_torch_train import tiny_config

    path = tiny_config(root, max_iters=max_iters, val_freq=2)
    with open(path) as f:
        cfg = json.load(f)
    cfg["model"]["use_pallas"] = False
    os.remove(path)
    yml = os.path.join(root, "cfg.yml")
    with open(yml, "w") as f:
        yaml.safe_dump(cfg, f)
    return yml


def run_dir(root: str, cfg: str, ckpt_path: str) -> str:
    """A run directory to resume from: the config and one checkpoint (and
    an orbax directory's meta file)."""
    os.makedirs(os.path.join(root, "checkpoints"))
    shutil.copy(cfg, root)
    name = os.path.basename(ckpt_path)
    if os.path.isdir(ckpt_path):
        shutil.copytree(ckpt_path, os.path.join(root, "checkpoints", name))
        shutil.copy(ckpt_path + ".meta.json", os.path.join(root, "checkpoints"))
    else:
        shutil.copy(ckpt_path, os.path.join(root, "checkpoints", name))
    return root


def drop_train_log_handlers() -> None:
    """Both packages log to the logger named "train"; the JAX package's adds
    its run's file only to a logger without handlers."""
    import logging

    logger = logging.getLogger("train")
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()


def logged_losses(run: str) -> list:
    with open(os.path.join(run, "log.txt")) as f:
        return [(kind, int(it), float(v)) for kind, it, v in re.findall(
            r"\[(Train|Validate)\] Iter (\d+) \| Loss (\S+)", f.read())]


def assert_losses_close(a: list, b: list) -> None:
    assert [x[:2] for x in a] == [x[:2] for x in b] and a
    np.testing.assert_allclose([x[2] for x in a], [x[2] for x in b], rtol=5e-4, atol=5e-5)


def test_jax_cli_resumes_from_a_port_written_orbax(tmp_path):
    """The port's train CLI with ``--ckpt_backend orbax`` and with ``pickle``
    from one seed (on the CPU: the same state) writes ``2.orbax`` and
    ``2.ckpt`` equal bit for bit; the JAX train CLI resumed from each logs
    the same losses."""
    from tsdiff_tpu.cli import train as jax_train_cli

    from tsdiff_tpu_torch.cli import train as train_cli

    cfg = cli_config(str(tmp_path), max_iters=2)
    ckpts = {}
    for backend in ("orbax", "pickle"):
        run = train_cli.main([cfg, "--logdir", str(tmp_path / f"port_{backend}"), "--device",
                              "cpu", "--ckpt_backend", backend])
        ckpts[backend], it = get_checkpoint_path(os.path.join(run, "checkpoints"))
        assert it == 2
        with open(os.path.join(run, "log.txt")) as f:
            log = f.read()
        assert f"[{backend}, the loop held" in log
        assert ("Checkpoint writes | orbax" in log) == (backend == "orbax")
    assert ckpts["orbax"].endswith("2.orbax") and ckpts["pickle"].endswith("2.ckpt")
    a, b = load_checkpoint(ckpts["orbax"]), load_checkpoint(ckpts["pickle"])
    for key in ("params", "ema_params"):
        assert_trees_bitwise_equal(a[key], b[key])
    assert_trees_bitwise_equal(a["opt_state"], list(b["opt_state"]))
    losses = {}
    for backend, path in ckpts.items():
        src = run_dir(str(tmp_path / f"src_{backend}"), cfg, path)
        drop_train_log_handlers()
        try:
            resumed = jax_train_cli.main([src, "--logdir", str(tmp_path / f"jax_{backend}"),
                                          "--max_iters", "4"])
        finally:
            drop_train_log_handlers()
        with open(os.path.join(resumed, "log.txt")) as f:
            assert f"Resuming from {os.path.join(src, 'checkpoints', os.path.basename(path))}" \
                in f.read()
        losses[backend] = logged_losses(resumed)
    assert_losses_close(losses["orbax"], losses["pickle"])


def test_port_cli_resumes_from_a_jax_written_orbax(tmp_path):
    """The JAX package's ``save_checkpoint_orbax`` and ``save_checkpoint`` of
    one JAX train state of the tiny config's model; the port's train CLI
    resumed from each logs the same losses, and from the orbax directory it
    writes ``.orbax`` checkpoints of its own."""
    from tsdiff_tpu.config import load_config as jax_load_config
    from tsdiff_tpu.train import init_train_state as jax_init_state
    from tsdiff_tpu.train import save_checkpoint as jax_save_checkpoint

    from tsdiff_tpu_torch.cli import train as train_cli
    from tsdiff_tpu_torch.convert import params_to_jax
    from tsdiff_tpu_torch.models import get_model

    cfg = cli_config(str(tmp_path), max_iters=4)
    config = jax_load_config(cfg)
    model = get_model(Config(config.model.to_dict()), generator=torch.Generator().manual_seed(5))
    params = jax.tree_util.tree_map(jnp.asarray, params_to_jax(model.state_dict()))
    jtx = jax_make_optimizer(config.train.optimizer, config.train.max_grad_norm)
    state = jax_init_state(None, jtx, params, ema_decay=0.999)
    rng = np.random.default_rng(6)
    opt = jax.tree_util.tree_map(
        lambda x: (jnp.asarray(rng.normal(scale=1e-3, size=x.shape) ** 2, x.dtype)
                   if jnp.issubdtype(x.dtype, jnp.floating) else jnp.full_like(x, 2)),
        state.opt_state)
    state = dataclasses.replace(state, opt_state=opt, step=jnp.asarray(2, jnp.int32))
    paths = {"orbax": str(tmp_path / "2.orbax"), "pickle": str(tmp_path / "2.ckpt")}
    jax_save_orbax(paths["orbax"], config, jax.device_get(state), None, iteration=2)
    jax_wait_for_saves()
    jax_save_checkpoint(paths["pickle"], config, jax.device_get(state), None, iteration=2)
    losses = {}
    for backend, path in paths.items():
        src = run_dir(str(tmp_path / f"src_{backend}"), cfg, path)
        resumed = train_cli.main([src, "--logdir", str(tmp_path / f"port_{backend}"), "--device",
                                  "cpu", "--ckpt_backend", backend])
        losses[backend] = logged_losses(resumed)
        written = sorted(os.listdir(os.path.join(resumed, "checkpoints")))
        assert written and all(w.endswith(".ckpt" if backend == "pickle" else
                                          (".orbax", ".orbax.meta.json")) for w in written)
    assert_losses_close(losses["orbax"], losses["pickle"])


def test_sampling_cli_from_orbax_members_equals_ckpt(tmp_path):
    """Two members written as ``.ckpt`` files and, through the writer, as
    ``.orbax`` directories: the sampling CLI (fused packed score, the CPU's
    plain version) gives the same samples from either, bit for bit."""
    import pickle

    from tsdiff_tpu_torch.cli import sampling
    from tsdiff_tpu_torch.convert import params_to_jax
    from tsdiff_tpu_torch.data import save_dataset
    from tsdiff_tpu_torch.data.synthetic import make_corpus
    from tsdiff_tpu_torch.models import get_model

    model_cfg = {**CFG.to_dict(), "feat_dim": 25, "num_diffusion_timesteps": 30}
    test_set = str(tmp_path / "test.pkl")
    save_dataset(test_set, make_corpus(3, seed=8))
    members = {"ckpt": [], "orbax": []}
    for seed in (1, 2):
        model = get_model(Config(model_cfg), generator=torch.Generator().manual_seed(seed))
        payload = {"format": "tsdiff_tpu.ckpt.v1", "config": {"model": model_cfg},
                   "params": params_to_jax(model.state_dict()), "opt_state": None,
                   "ema_params": None, "scheduler": None, "iteration": 10, "avg_val_loss": None}
        ckpt = str(tmp_path / f"m{seed}.ckpt")
        with open(ckpt, "wb") as f:
            pickle.dump(payload, f)
        members["ckpt"].append(ckpt)
        members["orbax"].append(str(tmp_path / f"m{seed}.orbax"))
        orbax_io.write_checkpoint_orbax(members["orbax"][-1], load_checkpoint(ckpt))
    samples = {}
    for kind, ckpts in members.items():
        out = sampling.main(ckpts + ["--test_set", test_set, "--save_dir",
                                     str(tmp_path / f"out_{kind}"), "--fused_score", "--device",
                                     "cpu", "--n_steps", "20", "--timestep_respacing", "5",
                                     "--batch_size", "3"])
        with open(out, "rb") as f:
            samples[kind] = pickle.load(f)
    assert len(samples["orbax"]) == len(samples["ckpt"]) == 3
    for a, b in zip(samples["orbax"], samples["ckpt"]):
        assert np.isfinite(a["pos_gen"]).all()
        np.testing.assert_array_equal(a["pos_gen"], b["pos_gen"])
