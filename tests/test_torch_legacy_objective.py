"""The dual encoder's objectives, walks, train step and CLIs in the port
against the JAX package.

JAX's draws cannot be made in torch, so each test makes them from the JAX
key exactly as the JAX function does (``jax.random.split``, ``randint``,
``normal``, ``fold_in``) and injects them into the port: the timesteps or
sigma levels and the noise of both losses, the per-step noise of both walks
(``dual_dynamic_sampling``, ``dsm_annealed_sampling`` with and without
``sigma_respacing``), and those of one optimizer step.  The sampling CLI's
captured-walk path (``WalkRunner`` on a ``DualWalk``, eager here) is held
against the eager walk on the same generator bit for bit; the train CLI's
checkpoint is held against the JAX model on the same weights.  Tolerance:
1e-5 of the largest magnitude of the JAX result (``close_rel``), walks after
a few steps at 1e-4.  H = 32, 2 SchNet blocks, 2 GIN layers, N <= 12.
"""

import json
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tsdiff_tpu.config import Config as JConfig
from tsdiff_tpu.diffusion import dual_objective as jdual
from tsdiff_tpu.diffusion.sampler import SamplingSettings as JSettings
from tsdiff_tpu.diffusion.schedules import DiffusionSchedule as JSchedule
from tsdiff_tpu.train import load_checkpoint as jax_load_checkpoint

from tsdiff_tpu_torch.config import Config
from tsdiff_tpu_torch.convert import params_from_jax
from tsdiff_tpu_torch.data import save_dataset
from tsdiff_tpu_torch.data.synthetic import make_conformer_corpus
from tsdiff_tpu_torch.diffusion import dual_objective as dual
from tsdiff_tpu_torch.diffusion.ensemble import DualEnsemble, load_members
from tsdiff_tpu_torch.diffusion.sampler import SamplingSettings
from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule

from test_torch_legacy_model import close_rel, legacy_setup, t_


def jax_draws(key, batch_size: int, levels: int, shape):
    """The levels and noise a JAX dual loss draws from ``key``."""
    key_t, key_eps = jax.random.split(key)
    half = jax.random.randint(key_t, (batch_size // 2 + 1,), 0, levels)
    t = jnp.concatenate([half, levels - half - 1])[:batch_size]
    return np.asarray(t), np.asarray(jax.random.normal(key_eps, shape))


def schedules(cfg):
    return JSchedule.from_config(JConfig(cfg)), DiffusionSchedule.from_config(Config(cfg))


@pytest.mark.parametrize("variant", ["mlp", "mlp_ts", "gaussian_smooth", "dsm"])
def test_dual_losses_match_jax(variant):
    s = legacy_setup(variant, seed=20)
    jb, tb, cfg = s["jb"], s["tb"], s["cfg"]
    key = jax.random.key(21)
    js, ts = schedules(cfg)
    B = jb.pos.shape[0]
    if cfg["type"] == "dsm":
        want, waux = jdual.dual_dsm_loss(s["jmodel"], s["params"], jb, key, anneal_power=2.0)
        t, noise = jax_draws(key, B, cfg["num_noise_level"], jb.pos.shape)
        got, aux = dual.dual_dsm_loss(s["tmodel"], tb, t=t_(t).long(), noise=t_(noise))
    else:
        want, waux = jdual.dual_diffusion_loss(s["jmodel"], s["params"], js, jb, key)
        t, noise = jax_draws(key, B, cfg["num_diffusion_timesteps"], jb.pos.shape)
        got, aux = dual.dual_diffusion_loss(s["tmodel"], ts, tb, t=t_(t).long(), noise=t_(noise))
        close_rel(aux["loss_global"], waux["loss_global"])
        close_rel(aux["loss_local"], waux["loss_local"])
    close_rel(got, want)
    close_rel(aux["loss_sum"], waux["loss_sum"])
    assert float(aux["n_nodes"]) == float(waux["n_nodes"])


def test_dual_loss_gradient_matches_jax():
    s = legacy_setup("mlp_ts", seed=22)
    jb, tb, cfg = s["jb"], s["tb"], s["cfg"]
    js, ts = schedules(cfg)
    key = jax.random.key(23)
    grads = jax.grad(lambda p: jdual.dual_diffusion_loss(s["jmodel"], p, js, jb, key)[0])(
        s["params"])
    want = params_from_jax(jax.device_get(grads))
    t, noise = jax_draws(key, jb.pos.shape[0], cfg["num_diffusion_timesteps"], jb.pos.shape)
    model = s["tmodel"].train()
    loss, _ = dual.dual_diffusion_loss(model, ts, tb, t=t_(t).long(), noise=t_(noise))
    names = [n for n, _ in model.named_parameters()]
    got = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    assert set(names) == set(want)
    for name, g in zip(names, got):
        close_rel(g, want[name].numpy(), tol=1e-4)


@pytest.mark.parametrize("clip_local", [None, 0.5])
def test_dual_eps_fn_matches_jax(clip_local):
    s = legacy_setup("mlp_ts_smooth", seed=24)
    jb, tb = s["jb"], s["tb"]
    pos = np.asarray(jb.pos) * 1.1
    for gate in (0.0, 1.0):
        want = jdual.make_dual_eps_fn(s["jmodel"], s["params"], jb, w_global=0.3, clip=2.0,
                                      clip_local=clip_local)(jnp.asarray(pos), jnp.float32(gate))
        got = dual.make_dual_eps_fn(s["tmodel"], tb, w_global=0.3, clip=2.0,
                                    clip_local=clip_local)(t_(pos), torch.tensor(gate))
        close_rel(got, want)


@pytest.mark.parametrize("rule,respacing,entry", [
    ("ld", None, None), ("ddpm", 4, None), ("generalized", None, None),
    ("ld", None, "denoise"),
])
def test_dual_dynamic_sampling_matches_jax(rule, respacing, entry):
    s = legacy_setup("mlp", seed=25)
    jb, tb, cfg = s["jb"], s["tb"], s["cfg"]
    js, ts = schedules(cfg)
    kw = dict(sampling_type=rule, n_steps=6, step_lr=1e-5, clip=5.0,
              timestep_respacing=respacing, denoise_from_time_t=10 if entry else None)
    pos_init = np.asarray(jax.random.normal(jax.random.key(26), jb.pos.shape))
    key = jax.random.key(27)
    jeps = jdual.make_dual_eps_fn(s["jmodel"], s["params"], jb, clip=5.0)
    jpos, _, jnan = jdual.dual_dynamic_sampling(jeps, js, jnp.asarray(pos_init), jb.node_mask,
                                                key, JSettings(**kw))
    n_walk = respacing or 6
    _, key_scan = jax.random.split(key)
    noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key_scan, k),
                                                   jb.pos.shape)) for k in range(n_walk)])
    eps = dual.make_dual_eps_fn(s["tmodel"], tb, clip=5.0)
    res = dual.dual_dynamic_sampling(eps, ts, t_(pos_init), tb.node_mask,
                                     SamplingSettings(**kw, save_traj=True), noise=t_(noise))
    assert not bool(res.nan_detected) and not bool(jnan)
    assert res.traj.shape[0] == n_walk
    close_rel(res.pos, jpos, tol=1e-4)


@pytest.mark.parametrize("m", [None, 3])
def test_dsm_annealed_sampling_matches_jax(m):
    s = legacy_setup("dsm", seed=28)
    jb, tb = s["jb"], s["tb"]
    sigmas = s["jmodel"].sigmas
    pos_init = np.asarray(jax.random.normal(jax.random.key(29), jb.pos.shape))
    key = jax.random.key(30)
    jeps = jdual.make_dual_eps_fn(s["jmodel"], s["params"], jb)
    jpos, jtraj, _ = jdual.dsm_annealed_sampling(
        jeps, sigmas, jnp.asarray(pos_init), jb.node_mask, key, n_steps=2, step_lr=1e-8,
        save_traj=True, sigma_respacing=m, min_sigma=0.02)
    n_walk = jtraj.shape[0]
    noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, k), jb.pos.shape))
                      for k in range(n_walk)])
    eps = dual.make_dual_eps_fn(s["tmodel"], tb)
    res = dual.dsm_annealed_sampling(eps, sigmas, t_(pos_init), tb.node_mask, n_steps=2,
                                     step_lr=1e-8, save_traj=True, sigma_respacing=m,
                                     min_sigma=0.02, noise=t_(noise))
    assert res.traj.shape[0] == n_walk == 2 * (m or int((sigmas >= 0.02).sum()))
    assert not bool(res.nan_detected) and np.isfinite(np.asarray(jpos)).all()
    close_rel(res.traj, jtraj, tol=1e-4)
    close_rel(res.pos, jpos, tol=1e-4)


def test_respaced_sigma_levels_match_jax():
    for lvl in (np.arange(10), np.arange(3, 10), np.arange(1)):
        for m in [None, *range(1, len(lvl) + 1)]:
            got = dual.respaced_sigma_levels(lvl, m)
            np.testing.assert_array_equal(got, jdual.respaced_sigma_levels(lvl, m))
            assert got[-1] == lvl[-1]
            assert len(got) == (m or len(lvl))
        for bad in (0, len(lvl) + 1):
            with pytest.raises(ValueError):
                dual.respaced_sigma_levels(lvl, bad)
            with pytest.raises(ValueError):
                jdual.respaced_sigma_levels(lvl, bad)


def test_protein_mode_pins_the_backbone():
    """With ``is_sidechain`` the backbone stays at ``pos_gt`` and only the
    sidechain moves; the losses take the mask, as JAX's."""
    s = legacy_setup("dsm", seed=31)
    jb, tb = s["jb"], s["tb"]
    sc = np.random.default_rng(31).random(jb.node_mask.shape) < 0.5
    pos_gt = np.asarray(jb.pos)
    eps = dual.make_dual_eps_fn(s["tmodel"], tb, is_sidechain=t_(sc))
    res = dual.dsm_annealed_sampling(eps, s["tmodel"].sigmas, t_(pos_gt) * 0.5, tb.node_mask,
                                     n_steps=1, is_sidechain=t_(sc), pos_gt=t_(pos_gt),
                                     generator=torch.Generator().manual_seed(0))
    keep = ~(sc & np.asarray(jb.node_mask))
    np.testing.assert_array_equal(res.pos.numpy()[keep], pos_gt[keep])
    key = jax.random.key(32)
    want, _ = jdual.dual_dsm_loss(s["jmodel"], s["params"], jb, key, is_sidechain=jnp.asarray(sc))
    t, noise = jax_draws(key, jb.pos.shape[0], 10, jb.pos.shape)
    got, _ = dual.dual_dsm_loss(s["tmodel"], tb, t=t_(t).long(), noise=t_(noise),
                                is_sidechain=t_(sc))
    close_rel(got, want)


@pytest.mark.parametrize("variant", ["mlp", "dsm"])
def test_dual_train_step_matches_jax(variant):
    """One optimizer step of the port's ``make_train_step`` (dispatched to
    the dual objective by ``get_objective``) against the JAX package's on
    the same draws: the loss and every parameter after the update."""
    import optax  # noqa: F401  (the JAX trainer's optimizer)
    from tsdiff_tpu.train import trainer as jtrainer

    from tsdiff_tpu_torch.train import get_objective, init_train_state, make_optimizer
    from tsdiff_tpu_torch.train import make_train_step

    s = legacy_setup(variant, seed=33)
    jb, tb, cfg = s["jb"], s["tb"], s["cfg"]
    js, ts = schedules(cfg)
    opt = {"type": "adam", "lr": 1e-3, "beta1": 0.95, "beta2": 0.999, "weight_decay": 0.0}
    jtx = jtrainer.make_optimizer(JConfig(opt), 1e4)
    jstep = jtrainer.make_train_step(s["jmodel"], jtx, js, anneal_power=2.0)
    jstate = jtrainer.init_train_state(s["jmodel"], jtx, s["params"])
    key = jax.random.key(34)
    jstate, jm = jstep(jstate, jb, key, 1e-3)

    model = s["tmodel"].train()
    _, (lo, hi) = get_objective(model, ts)
    assert (lo, hi) == (0, cfg["num_noise_level"] if variant == "dsm"
                        else cfg["num_diffusion_timesteps"])
    t, noise = jax_draws(key, jb.pos.shape[0], hi, jb.pos.shape)
    tx = make_optimizer(Config(opt), 1e4)
    step = make_train_step(model, tx, ts, anneal_power=2.0)
    _, metrics = step(init_train_state(model, tx), tb, 1e-3, t=t_(t).long(), noise=t_(noise))
    close_rel(metrics["loss"], jm["loss"])
    want = params_from_jax(jax.device_get(jstate.params))
    for name, p in model.named_parameters():
        close_rel(p, want[name].numpy(), tol=1e-5)


# ---- the CLIs, on the CPU ----


def legacy_run_config(root: str, variant: str, iters: int = 4) -> str:
    from test_torch_legacy_model import legacy_config

    graphs = make_conformer_corpus(6, seed=3, conformers=3)
    save_dataset(os.path.join(root, "train.pkl"), graphs[:12])
    save_dataset(os.path.join(root, "val.pkl"), graphs[12:])
    cfg = {
        "model": {**legacy_config(variant), "hidden_dim": 16},
        "train": {"seed": 2021, "batch_size": 4, "val_freq": 2, "log_freq": 2,
                  "max_iters": iters, "max_grad_norm": 1e4, "anneal_power": 2.0,
                  "optimizer": {"type": "adam", "lr": 1e-3, "weight_decay": 0.0,
                                "beta1": 0.95, "beta2": 0.999},
                  "scheduler": {"type": "plateau", "factor": 0.6, "patience": 10,
                                "min_lr": 2e-5}},
        "dataset": {"train": os.path.join(root, "train.pkl"),
                    "val": os.path.join(root, "val.pkl")},
    }
    path = os.path.join(root, f"{variant}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


@pytest.mark.parametrize("variant", ["mlp", "dsm"])
def test_train_cli_trains_the_dual_encoder(tmp_path, variant):
    """The train CLI on a dual-encoder config: finite losses in the log, a
    checkpoint the JAX package loads whose weights score as the port's."""
    from tsdiff_tpu_torch.cli import train as train_cli

    from test_torch_legacy_model import batches, legacy_graphs

    cfg = legacy_run_config(str(tmp_path), variant)
    run = train_cli.main([cfg, "--logdir", str(tmp_path / "logs"), "--device", "cpu"])
    with open(os.path.join(run, "log.txt")) as f:
        log = f.read()
    assert "DualEncoderEpsNetwork" in log and "device-resident corpus" in log
    losses = [float(line.split("Loss ")[1].split()[0]) for line in log.splitlines()
              if "[Validate]" in line]
    assert len(losses) == 2 and np.isfinite(losses).all()
    ckpt = sorted(os.listdir(os.path.join(run, "checkpoints")))[-1]
    ck = jax_load_checkpoint(os.path.join(run, "checkpoints", ckpt))
    from tsdiff_tpu.models import get_model as jax_get_model
    from tsdiff_tpu_torch.models import get_model

    jmodel = jax_get_model(JConfig(ck["config"]["model"]))
    model = get_model(Config(ck["config"]["model"]))
    model.load_state_dict(params_from_jax(ck["params"]))
    jb, tb = batches(legacy_graphs(np.random.default_rng(35), (6, 9), ts=False))
    t = np.array([1, 2])
    eg, _, edges, _ = jmodel.apply(ck["params"], jb.atom_type, jb.pos, jb.bond_mat, jb.node_mask,
                                   time_step=jnp.asarray(t))
    teg, *_ = model(tb.atom_type, tb.pos, tb.bond_mat, tb.node_mask, time_step=t_(t).long())
    m = np.asarray(edges.mask_global)[..., None]
    close_rel(teg.detach().numpy() * m, np.asarray(eg) * m)


def _write_members(root, variant, n=2):
    paths = []
    for m in range(n):
        s = legacy_setup(variant, seed=40 + m)
        cfg = {**s["cfg"]}
        paths.append(os.path.join(root, f"m{m}.ckpt"))
        with open(paths[-1], "wb") as f:
            pickle.dump({"format": "tsdiff_tpu.ckpt.v1", "config": {"model": cfg},
                         "params": s["params"], "ema_params": None}, f)
    return paths


@pytest.mark.parametrize("variant,extra", [
    ("mlp", ["--n_steps", "6", "--timestep_respacing", "3"]),
    ("dsm", ["--n_steps", "2", "--sigma_respacing", "3"]),
])
def test_sampling_cli_walks_the_dual_ensemble(tmp_path, variant, extra):
    """The sampling CLI on two dual-encoder members: its runner (a
    ``WalkRunner`` on a ``DualWalk``) gives the eager walk's samples on the
    same generator draws, bit for bit, finite and in the physical frame;
    ``--fused_score`` is ignored for the dual encoder."""
    from tsdiff_tpu_torch.cli import sampling
    from tsdiff_tpu_torch.core.graph import from_numpy_graphs
    from tsdiff_tpu_torch.diffusion.sampler import final_frame_scale

    from test_torch_legacy_model import legacy_graphs

    ckpts = _write_members(str(tmp_path), variant)
    graphs = legacy_graphs(np.random.default_rng(36), (7, 11, 9), ts=False)
    for i, g in enumerate(graphs):
        g["smiles"] = f"mol{i}"
    test_set = str(tmp_path / "test.pkl")
    save_dataset(test_set, graphs)
    out = sampling.main(ckpts + ["--test_set", test_set, "--save_dir", str(tmp_path / "gen"),
                                 "--device", "cpu", "--batch_size", "3", "--step_lr", "1e-5",
                                 "--fused_score"] + extra)
    with open(out, "rb") as f:
        results = pickle.load(f)
    assert [r["smiles"] for r in results] == ["mol0", "mol1", "mol2"]

    members, cfg = load_members(ckpts, "cpu", torch.float32)
    batch = from_numpy_graphs(graphs, max_nodes=16)
    ens = DualEnsemble(members)
    step = ens.step_fn(ens.prepare(batch))
    eps = lambda pos, gate, time_step: step(pos, gate, time_step, 1000.0, 0.2)  # noqa: E731
    gen = torch.Generator().manual_seed(2022)
    pos_init = torch.randn((3, 16, 3), generator=gen)
    gen.manual_seed(2022 * 7919)
    if variant == "dsm":
        res = dual.dsm_annealed_sampling(eps, members[0].sigmas, pos_init, batch.node_mask,
                                         n_steps=2, step_lr=1e-5, sigma_respacing=3,
                                         generator=gen)
        scale = 1.0
    else:
        schedule = DiffusionSchedule.from_config(cfg)
        settings = SamplingSettings(n_steps=6, step_lr=1e-5, timestep_respacing=3)
        res = dual.dual_dynamic_sampling(eps, schedule, pos_init, batch.node_mask, settings,
                                         generator=gen)
        scale = final_frame_scale(schedule, settings)
    for b, r in enumerate(results):
        n = len(r["atom_type"])
        assert np.isfinite(r["pos_gen"]).all()
        np.testing.assert_array_equal(r["pos_gen"], (res.pos[b, :n] * scale).numpy())


def test_chip_smoke_legacy_config_is_qm9_default():
    """``chip_smoke.py`` phase 12 writes configs/geodiff_legacy/qm9_default.yml
    out as JSON, so that it needs no PyYAML: the same blocks."""
    import yaml

    import chip_smoke

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "configs", "geodiff_legacy", "qm9_default.yml")) as f:
        cfg = yaml.safe_load(f)
    assert chip_smoke.QM9_DEFAULT == {"model": cfg["model"], "train": cfg["train"]}


def test_service_refuses_dual_members(tmp_path):
    """The service serves condensed-encoder members only, as the JAX
    service, whose batches need the condensed model's features."""
    from tsdiff_tpu_torch.serve import SamplerService

    ckpts = _write_members(str(tmp_path), "mlp", n=1)
    with pytest.raises(NotImplementedError, match="dualenc"):
        SamplerService(ckpts, n_steps=4, dtype="float32", device="cpu", capture=False)
