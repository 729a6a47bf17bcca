"""The port's evaluate CLI against the JAX package's
(``tsdiff_tpu/cli/evaluate.py``, numpy only): the printed lines and the
``--out`` pickle must be equal, with and without ``--no-automorphisms``, on a
``samples_all.pkl`` written by the port's sampling CLI and on a hand-made
pickle holding graphs with symmetric atoms, a trajectory and entries that are
skipped.  ``--covmat`` on samples with no ``pos_ref`` stack and
``--protein`` on a hand-made protein results pickle print and return what
the JAX CLI does (``tests/test_torch_conformer_eval.py`` runs ``--covmat`` on
conformer stacks, ``tests/test_torch_pdb.py`` ``--protein`` on sampled
proteins)."""

import pickle

import numpy as np
import jax
import pytest

from tsdiff_tpu.cli import evaluate as jax_evaluate
from tsdiff_tpu_torch.cli import evaluate, sampling
from tsdiff_tpu_torch.data.dataset import save_dataset
from tsdiff_tpu_torch.eval.dmae import graph_automorphisms

from test_condensenc import MODEL_CFG
from test_torch_common import small_setup
from test_torch_dmae import benzene_ring, ethane_methyls, methane_like


def ported_samples(tmp_path) -> str:
    """``samples_all.pkl`` of a short run of the port's sampling CLI."""
    _, (params,), _, _, _, graphs = small_setup(seed=8, sizes=(5, 9, 7, 6))
    ckpt = str(tmp_path / "m.ckpt")
    with open(ckpt, "wb") as f:
        pickle.dump({"format": "tsdiff_tpu.ckpt.v1", "config": {"model": MODEL_CFG.to_dict()},
                     "params": jax.device_get(params), "ema_params": None}, f)
    test_set = str(tmp_path / "test.pkl")
    save_dataset(test_set, graphs)
    return sampling.main([ckpt, "--test_set", test_set, "--save_dir", str(tmp_path / "out"),
                          "--n_steps", "6", "--batch_size", "2", "--device", "cpu",
                          "--fused_score"])


def hand_made_samples(tmp_path) -> str:
    """Symmetric graphs whose generated geometry moves symmetric atoms, a
    trajectory, and three entries to skip: no ``pos_gen``, no ``pos``, an
    all-zero ``pos``."""
    rng = np.random.default_rng(4)
    entries = []
    for make in (methane_like, ethane_methyls, benzene_ring):
        bond, types = make()
        n = len(types)
        pos = rng.normal(scale=1.5, size=(n, 3)).astype(np.float32)
        perm = graph_automorphisms(bond, types)[-1]   # symmetric atoms moved
        gen = pos[perm] + rng.normal(scale=0.1, size=(n, 3)).astype(np.float32)
        entries.append(dict(atom_type=types, bond_mat=bond, pos=pos, pos_gen=gen))
    traj = dict(entries[0])
    traj["pos_gen"] = np.stack([rng.normal(size=entries[0]["pos"].shape), entries[0]["pos_gen"]])
    entries.append(traj)
    entries.append({k: v for k, v in entries[1].items() if k != "pos_gen"})
    entries.append({k: v for k, v in entries[2].items() if k != "pos"})
    entries.append({**entries[2], "pos": np.zeros_like(entries[2]["pos"])})
    path = str(tmp_path / "hand.pkl")
    with open(path, "wb") as f:
        pickle.dump(entries, f)
    return path


@pytest.mark.parametrize("source", ["sampling_cli", "hand_made"])
@pytest.mark.parametrize("automorphisms", [True, False], ids=["matched", "identity"])
def test_evaluate_matches_jax(tmp_path, capsys, source, automorphisms):
    samples = ported_samples(tmp_path) if source == "sampling_cli" else hand_made_samples(tmp_path)
    capsys.readouterr()
    outs = {}
    for name, cli in (("port", evaluate), ("jax", jax_evaluate)):
        out = str(tmp_path / f"{name}.pkl")
        argv = ["--samples", samples, "--thresholds", "0.05", "0.5", "--out", out]
        stats = cli.main(argv + ([] if automorphisms else ["--no-automorphisms"]))
        with open(out, "rb") as f:
            outs[name] = (capsys.readouterr().out, stats, pickle.load(f))
    (p_text, p_stats, p_file), (j_text, j_stats, j_file) = outs["port"], outs["jax"]
    assert p_text == j_text
    for got in (p_stats, p_file):
        assert set(got) == set(j_file) == {"dmae", "thresholds"}
        np.testing.assert_array_equal(got["dmae"], j_file["dmae"])
        assert got["thresholds"] == j_file["thresholds"] == [0.05, 0.5]
    np.testing.assert_array_equal(j_stats["dmae"], j_file["dmae"])
    if source == "hand_made":
        assert "4 samples evaluated (3 skipped" in p_text
    else:
        assert "4 samples evaluated (0 skipped" in p_text


def test_evaluate_matches_over_automorphisms(tmp_path):
    """On the hand-made samples, where every generated geometry moved
    symmetric atoms, the matched D-MAE is below the identity's."""
    samples = hand_made_samples(tmp_path)
    matched = evaluate.main(["--samples", samples])["dmae"]
    ident = evaluate.main(["--samples", samples, "--no-automorphisms"])["dmae"]
    assert len(matched) == len(ident) == 4
    assert np.all(matched < ident)


@pytest.mark.parametrize("flag", ["--covmat", "--protein"])
def test_evaluate_rejects_what_is_not_ported(tmp_path, flag, capsys):
    samples = hand_made_samples(tmp_path)
    if flag == "--protein":   # ported: the JAX CLI's lines and stats
        results = [
            dict(name="a", pos_gen=np.ones((6, 3), np.float32) * 2,
                 pos_gt=np.ones((6, 3), np.float32),
                 is_sidechain=np.array([0, 0, 1, 1, 0, 1], bool),
                 coverage_counts=np.array([0, 0, 1, 1, 0, 0]), nan=False),
            dict(name="b", pos_gen=np.zeros((4, 3), np.float32),
                 pos_gt=np.zeros((4, 3), np.float32), is_sidechain=np.array([0, 1, 0, 0], bool),
                 coverage_counts=np.zeros(4, int), nan=True)]
        samples = str(tmp_path / "proteins_gen.pkl")
        with open(samples, "wb") as f:
            pickle.dump(results, f)
        stats = evaluate.main(["--samples", samples, flag])
        text = capsys.readouterr().out
        want = jax_evaluate.main(["--samples", samples, flag])
        assert text == capsys.readouterr().out
        assert "1 proteins evaluated" in text and stats["nan_flagged"] == want["nan_flagged"] == 1
        np.testing.assert_array_equal(stats["sidechain_rmsd"], want["sidechain_rmsd"])
        return
    stats = evaluate.main(["--samples", samples, flag])
    text = capsys.readouterr().out
    want = jax_evaluate.main(["--samples", samples, flag])
    assert text == capsys.readouterr().out
    assert "skipping COV/MAT" in text and "covmat" not in stats and "covmat" not in want
