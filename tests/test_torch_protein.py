"""The port's protein sidechain path against the JAX package's: the
covering-subgraph eps (``accumulate_protein_eps``), the sampler
(``diffusion/protein.py``), the ``protein_sampling`` CLI, the train CLI's
``dataset.type: sidechain`` and the checkpoints between the packages.

JAX's draws are rebuilt from its keys (``jax.random.split``, ``normal``,
``fold_in``) and injected into the port's sampler.  Tolerances: the eps and
one train step at 1e-5 of max|ref|, the walks at 1e-4; the ownership logic
and the subgraph draws bit for bit; a dp=2 run under two Gloo ranks against
one process at the sampling CLI's mesh tolerance.  Model: the dual encoder at H = 16, 2 + 2 convs, 5 sigma
levels; proteins: the port's compact synthetic ones of 16-24 residues.
"""

import glob
import json
import os
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsdiff_tpu.config import Config as JConfig
from tsdiff_tpu.core.graph import from_numpy_graphs as jpack
from tsdiff_tpu.diffusion.schedules import DiffusionSchedule as JSchedule
from tsdiff_tpu.models import get_model as jget_model
from tsdiff_tpu_torch.config import Config
from tsdiff_tpu_torch.convert import params_from_jax
from tsdiff_tpu_torch.core.graph import from_numpy_graphs
from tsdiff_tpu_torch.data.pdb import pdb_to_graph
from tsdiff_tpu_torch.data.synthetic import compact_protein_pdb
from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
from tsdiff_tpu_torch.models import get_model

from test_torch_legacy_model import close_rel, t_
from test_torch_legacy_objective import jax_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(network="dualenc", hidden_dim=16, num_convs=2, num_convs_local=2, cutoff=10.0,
           mlp_act="relu", beta_schedule="sigmoid", beta_start=1e-7, beta_end=2e-3,
           num_diffusion_timesteps=40, edge_order=3, edge_encoder="mlp", smooth_conv=False,
           type="dsm", sigma_begin=2.0, sigma_end=0.01, num_noise_level=5)
TRAIN = {"seed": 0, "batch_size": 4, "val_freq": 3, "log_freq": 3, "max_iters": 3,
         "max_grad_norm": 3000.0, "anneal_power": 2.0, "ema_decay": 0.999,
         "optimizer": {"type": "adam", "lr": 5e-4, "weight_decay": 0.0, "beta1": 0.95,
                       "beta2": 0.999},
         "scheduler": {"type": "plateau", "factor": 0.8, "patience": 10, "min_lr": 1.25e-4}}


def protein(n_res=16, seed=0):
    return pdb_to_graph(compact_protein_pdb(n_res, seed=seed), name=f"prot{seed}")


def models(kind="dsm", seed=0):
    """A JAX dual encoder with its parameters and the port's with the same
    weights; the schedules of both packages."""
    cfg = dict(CFG, type=kind)
    g = protein(8, seed=seed)
    jb = jpack([g], max_nodes=64)
    jmodel = jget_model(JConfig(cfg))
    params = jax.device_get(jmodel.init(jax.random.key(seed), jb.atom_type, jb.pos, jb.bond_mat,
                                        jb.node_mask, time_step=jnp.zeros((1,), jnp.int32)))
    tmodel = get_model(Config(cfg))
    tmodel.load_state_dict(params_from_jax(params))
    return dict(cfg=cfg, jmodel=jmodel, params=params, tmodel=tmodel.eval(),
                js=JSchedule.from_config(JConfig(cfg)), ts=DiffusionSchedule.from_config(Config(cfg)))


def test_accumulate_protein_eps_matches_jax():
    from tsdiff_tpu.diffusion.dual_objective import accumulate_protein_eps as jacc
    from tsdiff_tpu_torch.diffusion.dual_objective import accumulate_protein_eps

    m, g = models(), protein(16, seed=1)
    for time_step, gate in ((0, 1.0), (3, 0.0)):
        want, wc = jacc(m["jmodel"], m["params"], g, time_step=time_step, cutoff=7.0,
                        batch_size=3, sigma_gate=gate, seed=4)
        got, counts = accumulate_protein_eps(m["tmodel"], g, time_step=time_step, cutoff=7.0,
                                             batch_size=3, sigma_gate=gate, seed=4)
        np.testing.assert_array_equal(counts, wc)
        assert (counts[np.asarray(g["is_alpha"], bool)] > 0).all()
        close_rel(got, want)


def jax_protein_draws(key, dsm: bool):
    """``draws(i, shape, n_walk)`` replaying what the JAX sampler draws for
    batch i from ``key`` (batches are drawn in order)."""
    state = {"key": key}

    def draws(i, shape, n_walk):
        state["key"], k_init, k_run = jax.random.split(state["key"], 3)
        pos_init = jax.random.normal(k_init, shape)
        if not dsm:
            _, k_run = jax.random.split(k_run)   # key_init, key_scan
        noise = jax.vmap(lambda k: jax.random.normal(jax.random.fold_in(k_run, k), shape))(
            jnp.arange(n_walk))
        return t_(np.asarray(pos_init)), t_(np.asarray(noise))

    return draws


@pytest.mark.parametrize("kind,extra", [("dsm", {"n_steps": 3}),
                                        ("dsm", {"n_steps": 2, "sigma_respacing": 3}),
                                        ("diffusion", {"step_lr": 1e-7, "clip": 20.0})])
def test_sample_protein_sidechains_matches_jax(kind, extra):
    from tsdiff_tpu.diffusion.protein import sample_protein_sidechains as jsample
    from tsdiff_tpu_torch.diffusion.protein import sample_protein_sidechains

    m, g = models(kind), protein(16, seed=2)
    kw = dict(cutoff=7.0, batch_size=3, seed=5, **{"step_lr": 1e-6, **extra})
    key = jax.random.key(9)
    want, wc, wnan = jsample(m["jmodel"], m["params"], g, key,
                             schedule=m["js"] if kind == "diffusion" else None, **kw)
    got, counts, nan = sample_protein_sidechains(
        m["tmodel"], g, schedule=m["ts"] if kind == "diffusion" else None,
        draws=jax_protein_draws(key, kind == "dsm"), **kw)
    assert not wnan and not nan
    np.testing.assert_array_equal(counts, wc)
    sc = np.asarray(g["is_sidechain"], bool)
    np.testing.assert_array_equal(got[~sc], np.asarray(g["pos"])[~sc])  # backbone exact
    assert np.abs(got[sc] - g["pos"][sc]).max() > 0.1                   # sidechains moved
    close_rel(got, want, tol=1e-4)


def test_ownership_never_averages_equal_jax(monkeypatch):
    """The walk replaced by the same fake in both packages (each subgraph's
    sidechains moved by its own offset): ``pos_out`` and ``counts`` equal
    bit for bit, each residue from one subgraph."""
    import tsdiff_tpu.diffusion.protein as jprotein
    from tsdiff_tpu_torch.diffusion.captured import WalkRunner
    from tsdiff_tpu_torch.diffusion.protein import sample_protein_sidechains

    m, g = models(), protein(24, seed=3)
    jcalls, tcalls = [], []

    def jfake(eps_fn, sigmas, pos_init, node_mask, key, **kw):
        pos_gt = kw["pos_gt"]
        B = pos_gt.shape[0]
        offs = (jnp.arange(B, dtype=jnp.float32) + 1 + len(jcalls) * 10)[:, None, None]
        jcalls.append(B)
        return jnp.where(kw["is_sidechain"][..., None], pos_gt + offs, pos_gt), None, False

    def tfake(self, batch, pos_init, noise):
        B = batch.pos.shape[0]
        offs = (torch.arange(B, dtype=torch.float32) + 1 + len(tcalls) * 10)[:, None, None]
        tcalls.append(B)
        out = torch.where(batch.is_sidechain[..., None], batch.pos + offs, batch.pos)
        return out.numpy(), False

    monkeypatch.setattr(jprotein, "dsm_annealed_sampling", jfake)
    monkeypatch.setattr(WalkRunner, "run", tfake)
    want, wc, _ = jprotein.sample_protein_sidechains(m["jmodel"], m["params"], g,
                                                     jax.random.key(1), cutoff=6.0, batch_size=2)
    got, counts, _ = sample_protein_sidechains(m["tmodel"], g, torch.Generator(), cutoff=6.0,
                                               batch_size=2)
    assert tcalls == jcalls and len(tcalls) > 2
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(counts, wc)
    sc, atom2res = np.asarray(g["is_sidechain"], bool), np.asarray(g["atom2res"])
    disp = got - g["pos"]
    for r in np.unique(atom2res[sc]):
        assert len(np.unique(np.round(disp[sc & (atom2res == r)], 5))) == 1


def test_nan_subgraph_is_skipped(monkeypatch):
    """A subgraph whose walk is NaN on its sidechain is not scored."""
    from tsdiff_tpu_torch.diffusion.captured import WalkRunner
    from tsdiff_tpu_torch.diffusion.protein import sample_protein_sidechains

    m, g = models(), protein(16, seed=4)

    def nan_first(self, batch, pos_init, noise):
        out = torch.where(batch.is_sidechain[..., None], batch.pos + 1.0, batch.pos)
        out[0] = float("nan")
        return out.numpy(), True

    monkeypatch.setattr(WalkRunner, "run", nan_first)
    got, counts, nan = sample_protein_sidechains(m["tmodel"], g, torch.Generator(), cutoff=7.0,
                                                 batch_size=2)
    assert nan and np.isfinite(got).all()
    _, full, _ = sample_protein_sidechains(m["tmodel"], g, torch.Generator(), cutoff=7.0,
                                           batch_size=64)
    assert counts.sum() < full.sum()


# -- the CLIs -----------------------------------------------------------------


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A protein set written by ``preprocessing --pdb_glob``, a JAX-written
    checkpoint and a port-trained one (the train CLI in sidechain mode)."""
    from tsdiff_tpu.train import save_checkpoint as jsave
    from tsdiff_tpu.train.trainer import TrainState as JState
    from tsdiff_tpu_torch.cli import preprocessing, train

    root = tmp_path_factory.mktemp("protein")
    (root / "pdbs").mkdir()
    for i, n_res in enumerate((12, 20)):
        (root / "pdbs" / f"p{i}.pdb").write_text(compact_protein_pdb(n_res, seed=10 + i))
    prot = preprocessing.main(["--pdb_glob", str(root / "pdbs" / "*.pdb"),
                               "--save_dir", str(root)])
    m = models(seed=6)
    jckpt = str(root / "jax.ckpt")
    jsave(jckpt, JConfig(model=m["cfg"]), JState(params=m["params"], opt_state=None,
                                                 step=jnp.asarray(0), ema_params=m["params"]))
    config = {"model": CFG, "train": TRAIN,
              "dataset": {"type": "sidechain", "train": prot, "val": prot, "cutoff": 7.0,
                          "subgraphs_per_protein": 3}}
    (root / "sc.json").write_text(json.dumps(config))
    log_dir = train.main([str(root / "sc.json"), "--logdir", str(root / "logs"), "--device",
                          "cpu"])
    port_ckpt = sorted(glob.glob(os.path.join(log_dir, "checkpoints", "*.ckpt")))[-1]
    return dict(root=root, prot=prot, jckpt=jckpt, port_ckpt=port_ckpt, log_dir=log_dir,
                config=config)


def _results(path):
    with open(path, "rb") as f:
        return pickle.load(f)


FLAGS = ["--cutoff", "7.0", "--n_steps", "2", "--batch_size", "2", "--step_lr", "1e-5"]


def test_protein_sampling_cli_on_a_jax_checkpoint(workdir):
    """The port's CLI on the CPU: the JAX CLI's keys, the backbone exact,
    every sidechain covered, ``--write_pdb`` files named as JAX's, and the
    evaluate CLI's ``--protein`` stats on the result."""
    from tsdiff_tpu.cli import protein_sampling as jcli
    from tsdiff_tpu_torch.cli import evaluate, protein_sampling

    root = workdir["root"]
    out = protein_sampling.main([workdir["jckpt"], "--protein_set", workdir["prot"],
                                 "--save_dir", str(root / "gen"), "--device", "cpu",
                                 "--write_pdb", "--use_ema", *FLAGS])
    ref = jcli.main([workdir["jckpt"], "--protein_set", workdir["prot"], "--save_dir",
                     str(root / "jgen"), "--write_pdb", "--use_ema", *FLAGS])
    got, want = _results(out), _results(ref)
    assert len(got) == len(want) == 2
    for r, w in zip(got, want):
        assert list(r) == list(w)
        assert r["name"] == w["name"]
        sc = r["is_sidechain"]
        np.testing.assert_array_equal(r["pos_gen"][~sc], r["pos_gt"][~sc])
        np.testing.assert_array_equal(r["pos_gt"], w["pos_gt"])
        assert (r["coverage_counts"][sc] > 0).all() and np.isfinite(r["pos_gen"]).all()
    names = lambda d: sorted(os.path.basename(p) for p in glob.glob(str(d / "*_gen.pdb")))  # noqa
    assert names(root / "gen") == names(root / "jgen") and len(names(root / "gen")) == 2
    stats = evaluate.main(["--samples", out, "--protein"])
    assert len(stats["sidechain_rmsd"]) == 2


def test_protein_sampling_cli_on_an_orbax_checkpoint(workdir):
    """The JAX-written checkpoint rewritten as an ``.orbax`` directory by the
    port's writer samples as the ``.ckpt`` does, bit for bit."""
    from tsdiff_tpu_torch.cli import protein_sampling
    from tsdiff_tpu_torch.train import load_checkpoint
    from tsdiff_tpu_torch.train.orbax_io import write_checkpoint_orbax

    root = workdir["root"]
    orbax_dir = str(root / "jax_as.orbax")
    write_checkpoint_orbax(orbax_dir, load_checkpoint(workdir["jckpt"]))
    got = {}
    for name, ckpt in (("ckpt", workdir["jckpt"]), ("orbax", orbax_dir)):
        got[name] = _results(protein_sampling.main(
            [ckpt, "--protein_set", workdir["prot"], "--save_dir", str(root / f"gen_{name}"),
             "--device", "cpu", "--use_ema", *FLAGS]))
    assert len(got["orbax"]) == len(got["ckpt"]) == 2
    for a, b in zip(got["orbax"], got["ckpt"]):
        assert np.isfinite(a["pos_gen"]).all()
        np.testing.assert_array_equal(a["pos_gen"], b["pos_gen"])


def test_protein_sampling_cli_defaults_to_cuda():
    from tsdiff_tpu_torch.cli import protein_sampling, train

    assert protein_sampling.parse_args(["c", "--protein_set", "p", "--save_dir", "s"]).device \
        == "cuda"
    assert train.parse_args(["c.json"]).device == "cuda"


def test_port_trained_checkpoint_samples_in_jax(workdir):
    """The train CLI's sidechain checkpoint loads in JAX's protein_sampling,
    and the port's train log shows the sidechain mode and streamed batches."""
    from tsdiff_tpu.cli import protein_sampling as jcli

    log = open(os.path.join(workdir["log_dir"], "log.txt")).read()
    assert "sidechain mode: 2 fixed val subgraphs" in log
    assert "batches stream through the prefetcher" in log
    ref = jcli.main([workdir["port_ckpt"], "--protein_set", workdir["prot"], "--save_dir",
                     str(workdir["root"] / "jgen_port"), *FLAGS])
    assert all(np.isfinite(r["pos_gen"]).all() for r in _results(ref))


def test_sidechain_draws_and_batches_equal_jax(workdir):
    """The train CLI's subgraph draws equal those of the JAX CLI's loop
    (``tsdiff_tpu/cli/train.py:167-183``) for the same seeds, and its
    batches carry the sidechain mask."""
    import tsdiff_tpu.data.pdb as jpdb
    from tsdiff_tpu.data.dataset import load_dataset as jload
    from tsdiff_tpu_torch.cli.train import sidechain_draws
    from tsdiff_tpu_torch.data import PaddedBatchLoader, TSDataset
    from test_torch_pdb import _equal

    config = Config(workdir["config"])
    draw = sidechain_draws(config)
    corpus = jload(workdir["prot"])[0]
    for seed, fix in ((0, True), (3, False), (4, False)):
        ds = jpdb.SidechainConformationDataset(corpus, cutoff=7.0, fix_subgraph=fix, seed=seed)
        want = [s for i in range(len(ds)) for _ in range(1 if fix else 3)
                for s in [ds[i]] if s is not None]
        got = draw(workdir["prot"], seed, fix)
        _equal(got, want, f"draw {seed}")
    loader = PaddedBatchLoader(TSDataset(got), 4, shuffle=True, seed=4, with_indices=True)
    for batch, idx in loader:
        assert batch.is_sidechain is not None
        assert not batch.is_sidechain[idx < 0].any()


def test_sidechain_train_step_matches_jax():
    """One optimizer step on a batch of protein subgraphs, JAX's draws
    injected: the loss and every parameter after the update (the trainer
    hands ``is_sidechain`` to the DSM objective in both packages)."""
    from tsdiff_tpu.data.pdb import SidechainConformationDataset
    from tsdiff_tpu.train import trainer as jtrainer
    from tsdiff_tpu_torch.train import init_train_state, make_optimizer, make_train_step

    m = models(seed=7)
    ds = SidechainConformationDataset([protein(16, seed=8)], cutoff=7.0, seed=1)
    subs = [s for s in (ds[0] for _ in range(4)) if s is not None]
    jb, tb = jpack(subs, max_nodes=96), from_numpy_graphs(subs, max_nodes=96)
    assert jb.is_sidechain is not None and tb.is_sidechain is not None
    opt = {"type": "adam", "lr": 1e-3, "beta1": 0.95, "beta2": 0.999, "weight_decay": 0.0}
    jtx = jtrainer.make_optimizer(JConfig(opt), 1e4)
    jstep = jtrainer.make_train_step(m["jmodel"], jtx, m["js"], anneal_power=2.0)
    key = jax.random.key(12)
    jstate, jm = jstep(jtrainer.init_train_state(m["jmodel"], jtx, m["params"]), jb, key, 1e-3)
    t, noise = jax_draws(key, jb.pos.shape[0], CFG["num_noise_level"], jb.pos.shape)
    model = m["tmodel"].train()
    tx = make_optimizer(Config(opt), 1e4)
    step = make_train_step(model, tx, m["ts"], anneal_power=2.0)
    _, metrics = step(init_train_state(model, tx), tb, 1e-3, t=t_(t).long(), noise=t_(noise))
    close_rel(metrics["loss"], jm["loss"])
    want = params_from_jax(jax.device_get(jstate.params))
    for name, p in model.named_parameters():
        close_rel(p, want[name].numpy())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_protein_sampling_dp2_equals_one_process(workdir):
    """``--mesh 2`` over two Gloo ranks on the CPU writes what one process
    writes, at the tolerance ``tests/test_torch_parallel.py`` holds the
    sampling CLI's mesh to (rtol 1e-5, atol 1e-6: a rank's model runs on
    half the rows, and the CPU's matrix products round by their row count);
    the coverage equal; only rank 0 writes."""
    root = workdir["root"]
    common = [sys.executable, "-m", "tsdiff_tpu_torch.cli.protein_sampling",
              workdir["port_ckpt"], "--protein_set", workdir["prot"], "--device", "cpu",
              *FLAGS]
    env = dict(os.environ, PYTHONPATH=REPO, TSDIFF_DIST_TIMEOUT_S="120")
    subprocess.run(common + ["--save_dir", str(root / "one")], env=env, check=True,
                   cwd=REPO, capture_output=True, timeout=300)
    port = _free_port()
    procs = [subprocess.Popen(common + ["--save_dir", str(root / f"dp2_{i}"), "--mesh", "2",
                                        "--multihost", "--coordinator", f"127.0.0.1:{port}",
                                        "--nprocs", "2", "--procid", str(i)],
                              env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    assert "split over dp=2 ranks over gloo" in logs[0]
    assert not (root / "dp2_1" / "proteins_gen.pkl").exists()
    got = _results(root / "dp2_0" / "proteins_gen.pkl")
    want = _results(root / "one" / "proteins_gen.pkl")
    assert len(got) == len(want) == 2
    for r, w in zip(got, want):
        np.testing.assert_allclose(r["pos_gen"], w["pos_gen"], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(r["coverage_counts"], w["coverage_counts"])


def test_chip_smoke_protein_config_is_the_yaml():
    """``chip_smoke.py`` phase 13 writes configs/protein_sidechain.yml out
    as JSON, so that it needs no PyYAML: the same blocks, the dataset's
    paths aside."""
    import yaml

    import chip_smoke

    with open(os.path.join(REPO, "configs", "protein_sidechain.yml")) as f:
        cfg = yaml.safe_load(f)
    dataset = {k: v for k, v in cfg["dataset"].items() if k not in ("train", "val")}
    assert chip_smoke.PROTEIN_SIDECHAIN == {"model": cfg["model"], "train": cfg["train"],
                                            "dataset": dataset}


def test_chip_smoke_gate_reads_chi1_modulo_the_backbone_mirror():
    """The protein gate's chains have a planar backbone: their mirror image
    through it keeps every distance.  On a chain mirrored whole, the signed
    chi1 accuracy is 0 and the mirror-blind one ``chip_smoke.py`` phase 13b
    holds to the gate's thresholds is 1; the trans-180 template stays a
    miss in both readings."""
    import chip_smoke
    from test_protein_gate import GAMMA_BOND, res_chain
    from tsdiff_tpu_torch.eval.protein import chi1_accuracy, chi1_quads, place_dihedral

    g = pdb_to_graph(res_chain(8, seed=7))
    mirrored = g["pos"] * np.array([1.0, 1.0, -1.0], np.float32)
    assert np.abs(g["pos"][~g["is_sidechain"], 2]).max() < 0.1   # the backbone is planar
    assert chi1_accuracy(mirrored, g["pos"], g) == (0.0, 8)
    hits, gauche, angles = chip_smoke.mirror_chi1(mirrored, g["pos"], g)
    assert (hits, gauche, len(angles)) == (8, 8, 8)
    trans = np.asarray(g["pos"], float).copy()
    for iN, iCA, iCB, iG in chi1_quads(g):
        trans[iG] = place_dihedral(trans[iN], trans[iCA], trans[iCB],
                                   GAMMA_BOND[g["res_name"][int(iG)]], 110.5, 180.0)
    assert chi1_accuracy(trans, g["pos"], g)[0] == 0.0
    assert chip_smoke.mirror_chi1(trans, g["pos"], g)[:2] == (0, 0)
    m = chip_smoke._gate_metrics([dict(g, pos_gen=mirrored, pos_gt=g["pos"],
                                       coverage_counts=np.ones(len(g["pos"]), int))])
    assert m["chi1"] == 0.0 and m["m_chi1"] == 1.0 and m["m_gauche"] == 1.0
    assert m["m_circ_R"] > 0.9
