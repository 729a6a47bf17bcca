"""The port's training slice against the JAX package: the denoising loss and
its gradient, the optimizer step (clip, Adam, weight decay, EMA), the LR
schedulers, and the train CLI end to end on the CPU.

Inputs are made from a numpy seed and fed to both packages.  The port cannot
draw JAX's random numbers, so each step's timesteps and noise are rebuilt
from the JAX key exactly as ``diffusion_loss`` draws them and injected into
the port.  JAX runs with ``use_pallas=False``; the port runs both ways (the
fused stack takes its plain twin on CPU tensors).  Tolerance: float32 at
rtol=5e-4, atol=5e-5 unless a test says otherwise."""

import json
import os
import re

import numpy as np
import jax
import pytest
import torch

from tsdiff_tpu.config import Config as JConfig
from tsdiff_tpu.diffusion.objective import diffusion_loss as jax_loss
from tsdiff_tpu.diffusion.objective import sample_antithetic_timesteps as jax_timesteps
from tsdiff_tpu.diffusion.schedules import DiffusionSchedule as JSchedule
from tsdiff_tpu.train import init_train_state as jax_init_state
from tsdiff_tpu.train import load_checkpoint as jax_load_checkpoint
from tsdiff_tpu.train import make_optimizer as jax_make_optimizer
from tsdiff_tpu.train import make_train_step as jax_make_train_step
from tsdiff_tpu.train import scheduler as jsched

from tsdiff_tpu_torch.cli import train as train_cli
from tsdiff_tpu_torch.config import Config, load_config
from tsdiff_tpu_torch.convert import params_from_jax
from tsdiff_tpu_torch.data import save_dataset
from tsdiff_tpu_torch.data.synthetic import make_corpus
from tsdiff_tpu_torch.diffusion.objective import diffusion_loss, sample_antithetic_timesteps
from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
from tsdiff_tpu_torch.ops import schnet_stack as ss
from tsdiff_tpu_torch.train import (
    get_checkpoint_path,
    init_train_state,
    load_checkpoint,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from tsdiff_tpu_torch.train import scheduler as tsched

from test_condensenc import MODEL_CFG
from test_torch_common import close, small_setup
from test_torch_dense_model import port_model

SCHEDULE_J = JSchedule.from_config(MODEL_CFG)
SCHEDULE_T = DiffusionSchedule.from_config(Config(MODEL_CFG.to_dict()))


def jax_draws(key, jb):
    """The timesteps and noise ``diffusion_loss`` draws from ``key``."""
    key_t, key_eps = jax.random.split(key)
    t = jax_timesteps(key_t, jb.batch_size, 0, SCHEDULE_J.num_timesteps)
    noise = jax.random.normal(key_eps, jb.pos.shape, jb.pos.dtype)
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(noise))


def test_antithetic_timesteps():
    t = sample_antithetic_timesteps(torch.Generator().manual_seed(0), 7, 3, 50)
    assert t.shape == (7,) and bool(((t >= 3) & (t < 50)).all())
    np.testing.assert_array_equal(t[4:].numpy(), (3 + 50 - 1 - t[:3]).numpy())


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "fused"])
def test_diffusion_loss_and_grads_match_jax(use_pallas):
    jmodel, (params,), jb, _, tb, _ = small_setup(seed=9)
    key = jax.random.key(11)

    def loss_fn(p):
        return jax_loss(jmodel, p, SCHEDULE_J, jb, key)

    (jl, jaux), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    t, noise = jax_draws(key, jb)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jaux["timesteps"]))

    tmodel = port_model(params, use_pallas)
    calls = ss.schnet_stack_bwd_reference.calls
    tl, taux = diffusion_loss(tmodel, SCHEDULE_T, tb, t=t, noise=noise)
    names, tparams = zip(*tmodel.named_parameters())
    tgrads = torch.autograd.grad(tl, tparams)
    assert ss.schnet_stack_bwd_reference.calls == calls + int(use_pallas)
    close(tl, jl)
    close(taux["loss_sum"], jaux["loss_sum"])
    assert float(taux["n_nodes"]) == float(jaux["n_nodes"])
    want = params_from_jax(jax.device_get(jgrads))
    assert set(want) == set(names)
    for name, g in zip(names, tgrads):
        scale = float(np.abs(want[name].numpy()).max())
        close(g, want[name], atol=max(5e-5, 1e-4 * scale))


CASES = {
    "adam": dict(max_grad_norm=3000.0, weight_decay=0.0),
    "clipped": dict(max_grad_norm=0.5, weight_decay=0.0),
    "weight_decay": dict(max_grad_norm=3000.0, weight_decay=0.01),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_match_jax(case):
    """Three steps: parameters, EMA and grad_norm after each.  The Adam
    update is roughly lr * sign(g) where |g| >> eps, so a parameter's
    tolerance is atol 5e-5 plus rtol on its own value."""
    opt = dict(type="adam", lr=5e-4, beta1=0.95, beta2=0.999,
               weight_decay=CASES[case]["weight_decay"])
    max_norm, lr, ema_decay = CASES[case]["max_grad_norm"], 5e-4, 0.999
    jmodel, (params,), jb, _, tb, _ = small_setup(seed=10)
    jtx = jax_make_optimizer(JConfig(opt), max_norm)
    jstate = jax_init_state(jmodel, jtx, params, ema_decay=ema_decay)
    jstep = jax_make_train_step(jmodel, jtx, SCHEDULE_J, ema_decay=ema_decay)

    tmodel = port_model(params)
    ttx = make_optimizer(Config(opt), max_norm)
    tstate = init_train_state(tmodel, ttx, ema_decay=ema_decay)
    tstep = make_train_step(tmodel, ttx, SCHEDULE_T, ema_decay=ema_decay)

    key = jax.random.key(3)
    for _ in range(3):
        key, k = jax.random.split(key)
        jstate, jm = jstep(jstate, jb, k, lr)
        t, noise = jax_draws(k, jb)
        tstate, tm = tstep(tstate, tb, lr, t=t, noise=noise)
        close(tm["grad_norm"], jm["grad_norm"])
        if case == "clipped":
            assert float(jm["grad_norm"]) > max_norm
        for tree, got in ((jstate.params, tstate.params), (jstate.ema_params, tstate.ema_params)):
            want = params_from_jax(jax.device_get(tree))
            assert set(want) == set(got)
            for name, v in got.items():
                close(v, want[name])
    assert tstate.step == 3 and tstate.opt_state["count"] == 3


def test_eval_step():
    _, (params,), jb, _, tb, _ = small_setup(seed=12)
    tmodel = port_model(params)
    ev = make_eval_step(tmodel, SCHEDULE_T)
    ls, nn = ev(tb, generator=torch.Generator().manual_seed(0))
    assert float(nn) == 32.0 and np.isfinite(float(ls)) and not ls.requires_grad


@pytest.mark.parametrize("kind", ["plateau", "expmin", "expmin_milestone"])
def test_schedulers_match_jax(kind):
    cfg = dict(type=kind, factor=0.8, patience=2, min_lr=1e-4, milestone=3)
    js = jsched.get_scheduler(JConfig(cfg), 1e-3)
    ts = tsched.get_scheduler(Config(cfg), 1e-3)
    metrics = [5.0, 4.0, 4.0, 4.0, 4.0, 3.9999, 3.0, 3.0, 3.0, 3.0] * 3
    assert [ts.step(m) for m in metrics] == [js.step(m) for m in metrics]
    assert ts.state_dict() == js.state_dict()


def tiny_config(root, **train):
    save_dataset(os.path.join(root, "train.pkl"), make_corpus(10, seed=1))
    save_dataset(os.path.join(root, "val.pkl"), make_corpus(3, seed=2))
    model = {**MODEL_CFG.to_dict(), "feat_dim": 25, "num_diffusion_timesteps": 30,
             "use_pallas": True}
    model["encoder"] = {**model["encoder"], "hidden_dim": 16}
    model["hidden_dim"] = 16
    cfg = {
        "model": model,
        "train": {"seed": 0, "batch_size": 4, "val_freq": 2, "log_freq": 1, "max_iters": 3,
                  "max_grad_norm": 3000.0, "ema_decay": 0.999,
                  "optimizer": {"type": "adam", "lr": 5e-4, "weight_decay": 0.0,
                                "beta1": 0.95, "beta2": 0.999},
                  "scheduler": {"type": "plateau", "factor": 0.8, "patience": 10,
                                "min_lr": 1.25e-4},
                  **train},
        "dataset": {"train": os.path.join(root, "train.pkl"),
                    "val": os.path.join(root, "val.pkl")},
    }
    path = os.path.join(root, "cfg.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def test_cli_train_writes_checkpoints_and_resumes(tmp_path):
    cfg = tiny_config(str(tmp_path))
    logs = str(tmp_path / "logs")
    calls = ss.schnet_stack_bwd_reference.calls
    run = train_cli.main([cfg, "--logdir", logs, "--device", "cpu"])
    assert ss.schnet_stack_bwd_reference.calls == calls + 3  # use_pallas: one per step
    path, it = get_checkpoint_path(os.path.join(run, "checkpoints"))
    assert it in (2, 3) and os.path.exists(os.path.join(run, "cfg.json"))
    ck = load_checkpoint(path)
    # the optimizer state in the JAX package's layout: (clip, Adam) of the optax chain
    assert ck["opt_state"][1]["count"] == it and ck["ema_params"] is not None
    jck = jax_load_checkpoint(path)
    assert jck["config"]["model"]["use_pallas"] is True

    resumed = train_cli.main([run, "--logdir", logs, "--device", "cpu", "--max_iters", "5"])
    _, it2 = get_checkpoint_path(os.path.join(resumed, "checkpoints"))
    assert it2 > it
    with open(os.path.join(resumed, "log.txt")) as f:  # a second run logs to its own dir
        assert "[Validate] Iter 00005" in f.read()
    # the resumed run starts at the checkpoint's iteration, as the JAX CLI does
    ck2 = load_checkpoint(os.path.join(resumed, "checkpoints", f"{it2}.ckpt"))
    count = ck2["opt_state"][1]["count"]
    assert count == it + (it2 - it + 1)


def test_cli_train_logs_throughput_of_real_graphs(tmp_path):
    """The CLI's closing line counts the real graphs (padding excluded) of
    every iteration after the first, in the loader's own shuffled plan."""
    from tsdiff_tpu_torch.data import PaddedBatchLoader, TSDataset, inf_iterator

    cfg = tiny_config(str(tmp_path), max_iters=4)
    run = train_cli.main([cfg, "--logdir", str(tmp_path / "logs"), "--device", "cpu"])
    plan = inf_iterator(PaddedBatchLoader(TSDataset(str(tmp_path / "train.pkl")), 4,
                                          shuffle=True, seed=0, with_indices=True))
    real = [int((next(plan)[1] >= 0).sum()) for _ in range(4)]
    assert min(real) < 4  # the plan has padded tails, which must not count
    with open(os.path.join(run, "log.txt")) as f:
        line = [ln for ln in f if "[Train] Throughput" in ln]
    assert len(line) == 1
    assert f"| Iters 00002-00004 | {sum(real[1:])} graphs in " in line[0]


def test_schedule_alphas_copied_to_a_device_once():
    a = SCHEDULE_T.alphas_on("cpu")
    assert a is SCHEDULE_T.alphas_on(torch.device("cpu"))
    np.testing.assert_array_equal(a.numpy(), SCHEDULE_T.alphas)


def test_cli_train_rejects_what_is_not_ported(tmp_path):
    """orbax (§A.2) is refused; the mesh flags are ported
    (tests/test_torch_parallel.py) and refuse what the JAX CLI's refuse: a
    cluster neither named by the three flags nor started by torchrun, and
    more slices than ranks.  ``dataset.type: sidechain`` is ported
    (tests/test_torch_protein.py): on a corpus of molecules it fails where
    the JAX CLI's does, at the first subgraph draw, for want of
    ``is_sidechain``."""
    cfg = tiny_config(str(tmp_path))
    base = [cfg, "--logdir", str(tmp_path / "logs"), "--device", "cpu"]
    with pytest.raises(NotImplementedError, match=r"not yet ported \(ROADMAP §A\.2"):
        train_cli.main(base + ["--ckpt_backend", "orbax"])
    with pytest.raises(ValueError, match="environment torchrun sets"):
        train_cli.main(base + ["--multihost"])
    with pytest.raises(ValueError, match="not divisible by 2 slices"):
        train_cli.main(base + ["--mesh_layout", "hybrid", "--num_slices", "2"])
    with open(cfg) as f:
        sidechain = json.load(f)
    sidechain["dataset"]["type"] = "sidechain"
    with open(cfg, "w") as f:
        json.dump(sidechain, f)
    with pytest.raises(KeyError, match="is_sidechain"):
        train_cli.main(base)


def test_cli_train_cuda_default_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is exercised by chip_smoke.py")
    cfg = tiny_config(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main([cfg, "--logdir", str(tmp_path / "logs")])


def test_load_config_json_and_yaml(tmp_path):
    d = {"model": {"hidden_dim": 8}, "train": {"seed": 1}}
    (tmp_path / "c.json").write_text(json.dumps(d))
    (tmp_path / "c.yml").write_text("model:\n  hidden_dim: 8\ntrain:\n  seed: 1\n")
    for name in ("c.json", "c.yml"):
        c = load_config(str(tmp_path / name))
        assert c.model.hidden_dim == 8 and c.to_dict() == d
    with pytest.raises(ValueError):
        load_config(str(tmp_path / "c.txt"))


@pytest.mark.parametrize("device_data", ["auto", "on", "off", "auto_over_budget"])
def test_cli_train_production_flags(tmp_path, monkeypatch, device_data):
    """The production command line (``--tag``, ``--dtype bfloat16``,
    ``--packed_train``, ``--device_data``) trains the packed objective to a
    checkpoint; ``auto`` streams only past the byte budget, and says so."""
    from tsdiff_tpu_torch.ops import packed_score as ps

    mode = device_data
    if device_data == "auto_over_budget":
        monkeypatch.setattr(train_cli, "DEVICE_DATA_BUDGET", 1)
        mode = "auto"
    cfg = tiny_config(str(tmp_path), max_iters=4)
    calls = (ss.schnet_stack_bwd_reference.calls, ps.packed_score_reference.calls)
    run = train_cli.main([cfg, "--logdir", str(tmp_path / "logs"), "--tag", "seed3", "--dtype",
                          "bfloat16", "--packed_train", "--device_data", mode, "--device", "cpu"])
    assert (ss.schnet_stack_bwd_reference.calls, ps.packed_score_reference.calls) == calls
    assert run.endswith("_seed3")
    path, it = get_checkpoint_path(os.path.join(run, "checkpoints"))
    ck = load_checkpoint(path)
    assert ck["config"]["model"]["packed_train"] is True and ck["opt_state"][1]["count"] == it
    with open(os.path.join(run, "log.txt")) as f:
        log = f.read()
    resident = "device-resident corpus" in log
    assert resident == (device_data in ("auto", "on"))
    assert ("budget); streaming" in log) == (device_data == "auto_over_budget")
    assert "packed_train=True" in log and "[Train] Throughput" in log
    losses = [float(v) for v in re.findall(r"\] Iter \d+ \| Loss (\S+)", log)]
    assert len(losses) == 4 + 2 and all(np.isfinite(losses))


def first_log_dir(cli_main, argv, monkeypatch, misc) -> str:
    """The run directory a train CLI names, without the timestamp; the CLI
    is stopped right after naming it."""
    made = []
    real = misc.get_new_log_dir

    def record(*args, **kw):
        made.append(real(*args, **kw))
        raise KeyboardInterrupt  # stop here: the name is all this test needs

    monkeypatch.setattr(misc, "get_new_log_dir", record)
    with pytest.raises(KeyboardInterrupt):
        cli_main(argv)
    monkeypatch.setattr(misc, "get_new_log_dir", real)
    return re.sub(r"\d{4}_\d\d_\d\d__\d\d_\d\d_\d\d", "<time>", os.path.basename(made[0]))


@pytest.mark.parametrize("case", ["tag", "name", "neither", "resume"])
def test_cli_train_names_its_log_dir_as_jax(tmp_path, monkeypatch, case):
    from tsdiff_tpu.cli import train as jax_train_cli
    from tsdiff_tpu.utils import misc as jax_misc

    from tsdiff_tpu_torch.utils import misc as port_misc

    cfg = tiny_config(str(tmp_path))
    if case == "resume":  # a previous run's directory: the JAX CLI reads its *.yml
        prev = tmp_path / "prev"
        prev.mkdir()
        (prev / "cfg.yml").write_text(open(cfg).read())
        cfg = str(prev)
    extra = {"tag": ["--tag", "seed4"], "name": ["--name", "run7"], "neither": [],
             "resume": ["--tag", "seed4"]}[case]
    argv = [cfg, "--logdir", str(tmp_path / "logs"), *extra]
    mine = first_log_dir(train_cli.main, argv + ["--device", "cpu"], monkeypatch, port_misc)
    want = first_log_dir(jax_train_cli.main, argv, monkeypatch, jax_misc)
    assert mine == want == {"tag": "cfg_<time>_seed4", "name": "cfg_<time>_run7",
                            "neither": "cfg_<time>", "resume": "cfg_<time>_seed4_resume"}[case]


def test_cli_train_debug_nans(tmp_path):
    """With ``--debug_nans`` a NaN position fails the run at its iteration,
    and anomaly detection is off again afterwards; without it the run goes on."""
    from tsdiff_tpu_torch.data import load_dataset

    cfg = tiny_config(str(tmp_path), max_iters=3, val_freq=3)
    graphs, _ = load_dataset(str(tmp_path / "train.pkl"))
    for g in graphs:
        g["pos"] = g["pos"].copy()
        g["pos"][0, 1] = np.nan
    save_dataset(str(tmp_path / "train.pkl"), graphs)
    base = [cfg, "--logdir", str(tmp_path / "logs"), "--device", "cpu", "--packed_train"]
    with pytest.raises(FloatingPointError, match=r"iteration 1: non-finite loss"):
        train_cli.main(base + ["--debug_nans"])
    assert not torch.is_anomaly_enabled()
    run = train_cli.main(base)
    with open(os.path.join(run, "log.txt")) as f:
        assert "[Train] Iter 00003 | Loss nan" in f.read()
