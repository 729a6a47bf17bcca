"""The train CLI's ``--pretrain`` and ``--profile`` on the CPU, and
checkpoint directories.

``--pretrain`` takes any file ``load_checkpoint`` reads: a ``.ckpt`` and a
reference ``.pt`` of the same weights give the same run, bit for bit; the
run starts from those weights with a fresh optimizer state, as the JAX
CLI's does.  ``--profile`` traces a stretch of iterations: ``trace.json`` and
the spans' host ms in the log."""

import json
import os
import pickle
import re

import pytest
import torch

from tsdiff_tpu_torch.cli import train as train_cli
from tsdiff_tpu_torch.config import load_config
from tsdiff_tpu_torch.convert import params_from_jax, params_to_jax
from tsdiff_tpu_torch.models import get_model
from tsdiff_tpu_torch.train import get_checkpoint_path, load_checkpoint

from test_torch_reference_ckpt import write_reference_pt
from test_torch_train import tiny_config


def warm_weights(cfg_path: str) -> dict:
    """A flax parameter tree for the tiny config's model, from seed 123."""
    cfg = load_config(cfg_path)
    model = get_model(cfg.model, generator=torch.Generator().manual_seed(123))
    return params_to_jax(model.state_dict())


def pretrain_run(root, fmt: str) -> dict:
    """One iteration of the tiny config warm-started from a ``fmt`` file of
    seed 123's weights: checks the log and the checkpoint, returns the
    parameters after the step."""
    os.makedirs(root)
    cfg = tiny_config(root, max_iters=1, val_freq=1)
    config = load_config(cfg)
    warm = warm_weights(cfg)
    path = os.path.join(root, f"warm.{fmt}")
    if fmt == "pt":
        write_reference_pt(path, config.to_dict(), warm)
    else:
        with open(path, "wb") as f:
            pickle.dump({"format": "tsdiff_tpu.ckpt.v1", "config": config.to_dict(),
                         "params": warm, "ema_params": None}, f)
    run = train_cli.main([cfg, "--logdir", os.path.join(root, "logs"), "--device", "cpu",
                          "--pretrain", path])
    with open(os.path.join(run, "log.txt")) as f:
        assert f"Warm-start weights from {path}" in f.read()
    ck = load_checkpoint(get_checkpoint_path(os.path.join(run, "checkpoints"))[0])
    assert ck["iteration"] == 1 and ck["opt_state"][1]["count"] == 1   # fresh optimizer state
    got, start = params_from_jax(ck["params"]), params_from_jax(warm)
    for name, p in got.items():   # one Adam step of about lr from the warm weights
        assert float((p - start[name]).abs().max()) <= 2 * config.train.optimizer.lr, name
    return got


def test_cli_pretrain_ckpt_and_pt_give_the_same_first_step(tmp_path):
    from_ckpt = pretrain_run(str(tmp_path / "ckpt"), "ckpt")
    from_pt = pretrain_run(str(tmp_path / "pt"), "pt")
    assert set(from_ckpt) == set(from_pt)
    for name, p in from_ckpt.items():
        assert torch.equal(p, from_pt[name]), name


@pytest.mark.parametrize("device_data", ["on", "off"])
def test_cli_profile_logs_phase_timings(tmp_path, device_data):
    """``--profile`` traces the iterations after the first (here 2 and 3):
    ``trace.json`` in the run directory, and a line per ``tsdiff.train.*``
    span with its host ms from the profiler's events."""
    cfg = tiny_config(str(tmp_path), max_iters=3)
    run = train_cli.main([cfg, "--logdir", str(tmp_path / "logs"), "--device", "cpu",
                          "--profile", "--device_data", device_data])
    with open(os.path.join(run, "log.txt")) as f:
        log = f.read()
    timings = log[log.index("Phase timings:"):]
    assert re.match(r"Phase timings: iterations 00002-00003 under torch.profiler", timings)
    for phase in ("tsdiff.train.data", "tsdiff.train.step"):
        m = re.search(rf"^\s*{re.escape(phase)}: +(\S+) ms total, +(\S+) ms a call \((\d+)x\)$",
                      timings, re.M)
        assert m is not None, phase
        assert int(m.group(3)) == 2 and float(m.group(1)) >= float(m.group(2)) > 0
    with open(os.path.join(run, "trace.json")) as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert {"tsdiff.train.data", "tsdiff.train.step"} <= names


def test_orbax_directory_is_refused_naming_its_roadmap_item(tmp_path):
    """An orbax directory is read now (tests/test_torch_orbax.py): one
    written by the port loads with its meta file; a directory without one
    raises naming the file it lacks."""
    from tsdiff_tpu_torch.train.orbax_io import write_checkpoint_orbax

    os.makedirs(tmp_path / "data")
    cfg = tiny_config(str(tmp_path / "data"))
    weights = warm_weights(cfg)
    path = str(tmp_path / "5.orbax")
    write_checkpoint_orbax(path, {"config": load_config(cfg).to_dict(), "params": weights,
                                  "opt_state": None, "ema_params": None, "iteration": 5})
    ck = load_checkpoint(path)
    assert ck["iteration"] == 5 and ck["format"] == "tsdiff_tpu.ckpt.v1"
    got = params_from_jax(ck["params"])
    for name, p in params_from_jax(weights).items():
        assert torch.equal(got[name], p), name
    os.makedirs(tmp_path / "bare")
    with pytest.raises(FileNotFoundError, match=r"bare\.meta\.json"):
        load_checkpoint(str(tmp_path / "bare"))


def test_profiling_utilities_on_the_cpu(tmp_path):
    from tsdiff_tpu_torch.utils.profiling import device_trace, span, span_totals

    assert span("train.step") is span("walk.round", tier=4)     # no profiler: one null context
    with device_trace(str(tmp_path / "trace")) as prof:
        for _ in range(2):
            with span("train.step", bucket=8):
                torch.ones(8, 8) @ torch.ones(8, 8)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    (name, (seconds, calls)), = span_totals(prof, "train.").items()
    assert name == "tsdiff.train.step" and calls == 2 and seconds > 0
