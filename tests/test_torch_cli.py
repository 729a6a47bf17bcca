"""The port's sampling CLI on the CPU (``--device cpu``), end to end on a tiny
checkpoint and a tiny .pkl test set: result pickles of the right shapes, the
NaN-retry bookkeeping, resume, the dense ensemble without ``--fused_score``,
``--quant int8``, and clear errors for what is refused."""

import os
import pickle
import sys

import numpy as np
import jax
import pytest
import torch

from tsdiff_tpu_torch.cli import sampling
from tsdiff_tpu_torch.data.dataset import save_dataset
from tsdiff_tpu_torch.ops import packed_score as ps
from tsdiff_tpu_torch.ops import packed_score_int8 as p8

from test_condensenc import MODEL_CFG
from test_torch_common import small_setup


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    _, params, _, _, _, graphs = small_setup(seed=6, sizes=(5, 9, 7), members=2)
    ckpts = []
    for m, p in enumerate(params):
        path = str(d / f"m{m}.ckpt")
        with open(path, "wb") as f:
            pickle.dump({"format": "tsdiff_tpu.ckpt.v1",
                         "config": {"model": MODEL_CFG.to_dict()},
                         "params": jax.device_get(p), "ema_params": None}, f)
        ckpts.append(path)
    for i, g in enumerate(graphs):
        g["smiles"] = f"g{i}"
    test_set = str(d / "test.pkl")
    save_dataset(test_set, graphs)
    return ckpts, test_set, graphs


def run(inputs, save_dir, *extra, fused=True):
    ckpts, test_set, _ = inputs
    return sampling.main(ckpts + [
        "--test_set", test_set, "--save_dir", str(save_dir), "--n_steps", "6",
        "--batch_size", "2", "--device", "cpu", "--sort_by_size", *extra,
    ] + (["--fused_score"] if fused else []))


def load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_cli_writes_samples(inputs, tmp_path):
    path = run(inputs, tmp_path)
    assert path == str(tmp_path / "samples_all.pkl")
    assert not os.path.exists(tmp_path / "samples_not_all.pkl")
    with open(path, "rb") as f:
        results = pickle.load(f)
    assert sorted(r["smiles"] for r in results) == ["g0", "g1", "g2"]
    assert [len(r["atom_type"]) for r in results] == [5, 7, 9]   # sorted by size
    for r in results:
        assert r["pos_gen"].shape == (len(r["atom_type"]), 3)
        assert np.isfinite(r["pos_gen"]).all()
        assert r["sampling_attempts"] == 1


def test_cli_bf16_traj_and_resume(inputs, tmp_path):
    path = run(inputs, tmp_path, "--dtype", "bfloat16", "--save_traj", "--end_idx", "2")
    with open(path, "rb") as f:
        results = pickle.load(f)
    assert len(results) == 2
    for r in results:
        assert r["pos_gen"].shape == (6, len(r["atom_type"]), 3)
    resumed = run(inputs, tmp_path / "resumed", "--resume", path)
    with open(resumed, "rb") as f:
        assert sorted(r["smiles"] for r in pickle.load(f)) == ["g0", "g1", "g2"]


def test_cli_rejects_what_is_not_ported(inputs, tmp_path, monkeypatch):
    """A .txt test set is featurized, which needs RDKit: without it the
    featurizer's ImportError, not a refusal of the format."""
    ckpts, test_set, _ = inputs
    base = ckpts + ["--save_dir", str(tmp_path), "--device", "cpu"]
    txt, feat_dict = tmp_path / "reactions.txt", tmp_path / "feat_dict.pkl"
    txt.write_text("[CH3:1][H:2]>>[CH2:1].[H:2]\n")
    feat_dict.write_bytes(pickle.dumps({"GetIsAromatic": {False: 0}}))
    monkeypatch.setitem(sys.modules, "rdkit", None)
    with pytest.raises(ImportError, match="RDKit is required"):
        sampling.main(base + ["--test_set", str(txt), "--feat_dict", str(feat_dict),
                              "--fused_score"])
    with pytest.raises(ValueError, match="--fused_score"):
        sampling.main(base + ["--test_set", test_set, "--quant", "int8"])


def test_cli_without_fused_score_runs_the_dense_ensemble(inputs, tmp_path):
    """No packed kernel op is called, and with the same seeds the samples
    agree with the packed run's (same scores up to float32 summation order,
    over 6 steps)."""
    calls = ps.packed_score_reference.calls, p8.packed_score_int8_reference.calls
    dense = load(run(inputs, tmp_path / "dense", fused=False))
    assert (ps.packed_score_reference.calls, p8.packed_score_int8_reference.calls) == calls
    packed = load(run(inputs, tmp_path / "packed"))
    assert ps.packed_score_reference.calls > calls[0]
    assert [r["smiles"] for r in dense] == [r["smiles"] for r in packed]
    for a, b in zip(dense, packed):
        assert a["pos_gen"].shape == (len(a["atom_type"]), 3) and a["sampling_attempts"] == 1
        np.testing.assert_allclose(a["pos_gen"], b["pos_gen"], rtol=1e-4, atol=1e-5)


def test_cli_quant_int8_runs_the_int8_op(inputs, tmp_path):
    calls = ps.packed_score_reference.calls, p8.packed_score_int8_reference.calls
    results = load(run(inputs, tmp_path, "--quant", "int8"))
    # 2 batches (2 + 1 reactions) of 6 steps, one op call per step for both members
    assert p8.packed_score_int8_reference.calls == calls[1] + 12
    assert ps.packed_score_reference.calls == calls[0]
    assert sorted(r["smiles"] for r in results) == ["g0", "g1", "g2"]
    for r in results:
        assert r["pos_gen"].shape == (len(r["atom_type"]), 3)
        assert np.isfinite(r["pos_gen"]).all() and r["sampling_attempts"] == 1


def test_cli_cuda_default_raises_without_a_card(inputs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is exercised by chip_smoke.py")
    ckpts, test_set, _ = inputs
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sampling.main(ckpts + ["--test_set", test_set, "--save_dir", str(tmp_path),
                               "--fused_score"])
