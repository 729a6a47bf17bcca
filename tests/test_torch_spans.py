"""The port's spans (``tsdiff_tpu_torch/utils/profiling.py``) and its NaN
round counter, on the CPU.

* With no profiler recording, ``span`` returns one shared null context.
* Under ``torch.profiler``: an eager ``WalkRunner`` round is one
  ``tsdiff.walk.round`` span carrying its ids, holding ``prepare``,
  ``start``, ``replay`` and ``readback`` in that order and no ``record``
  (eager rounds record no graph); ``from_numpy_graphs`` records
  ``pack.host`` and ``pack.copy``; a tiny train run records ``train.data``
  and ``train.step`` once an iteration, resident and streamed.
* ``WalkRunner.nan_rounds`` counts a round started from NaN positions, and
  the service's ``/healthz`` reports it.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tsdiff_tpu_torch import serve
from tsdiff_tpu_torch.cli import train as train_cli
from tsdiff_tpu_torch.config import Config as TConfig
from tsdiff_tpu_torch.core.graph import from_numpy_graphs
from tsdiff_tpu_torch.diffusion.captured import WalkRunner
from tsdiff_tpu_torch.diffusion.ensemble import make_ensemble
from tsdiff_tpu_torch.diffusion.sampler import SamplingSettings
from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
from tsdiff_tpu_torch.models import get_model
from tsdiff_tpu_torch.utils import profiling

from test_condensenc import MODEL_CFG
from test_data import make_graph_dicts
from test_torch_common import make_graphs
from test_torch_serve import ckpts, free_port, service  # noqa: F401  (ckpts: a fixture)
from test_torch_train import tiny_config


def spans(prof, prefix: str = "tsdiff.") -> list:
    """``(name, start_us, end_us)`` of the host's spans named ``prefix*``,
    in order of their start."""
    return [(ev.name, ev.time_range.start, ev.time_range.end) for ev in prof.events()
            if ev.device_type == DeviceType.CPU and ev.name.startswith(prefix)]


def small_runner(n_steps: int = 4):
    """A tiny condensed model's eager runner and a batch of three graphs."""
    cfg = TConfig(MODEL_CFG)
    model = get_model(cfg, generator=torch.Generator().manual_seed(0)).eval()
    batch = from_numpy_graphs(make_graphs(np.random.default_rng(3), (5, 8, 11)), max_nodes=12)
    runner = WalkRunner(make_ensemble([model]), DiffusionSchedule.from_config(cfg),
                        SamplingSettings(n_steps=n_steps), capture=False)
    return runner, batch


def test_span_without_a_profiler_is_the_shared_null_context():
    assert not torch.autograd.profiler._is_profiler_enabled
    first = profiling.span("walk.round", bucket=12, tier=3)
    assert first is profiling.span("pack.host") is profiling._NULL
    with first:
        pass


def test_eager_round_records_its_spans_in_order(monkeypatch):
    runner, batch = small_runner()
    given = []
    real = torch.profiler.record_function

    def recording(name, args=None):
        given.append((name, args))
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", recording)
    pos_init = torch.randn(batch.pos.shape, generator=torch.Generator().manual_seed(1))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runner.run(batch, pos_init, torch.Generator().manual_seed(2))
    walk = spans(prof, "tsdiff.walk.")
    names = [n for n, _, _ in walk]
    assert names == ["tsdiff.walk.round", "tsdiff.walk.prepare", "tsdiff.walk.start",
                     "tsdiff.walk.replay", "tsdiff.walk.readback"]
    _, r0, r1 = walk[0]
    for (_, s, e), (_, s_next, _) in zip(walk[1:], walk[2:] + [(None, r1, None)]):
        assert r0 <= s <= e <= s_next <= r1
    assert given[0] == ("tsdiff.walk.round", "bucket=12,tier=3,clip=1000.0,round=0")
    assert all(args is None for _, args in given[1:])


def test_packer_records_host_and_copy():
    graphs = make_graph_dicts(np.random.default_rng(0), [4, 7], feat_dim=8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        batch = from_numpy_graphs(graphs, max_nodes=8)
    assert batch.pos.shape == (2, 8, 3)
    (h, h0, h1), (c, c0, c1) = spans(prof)
    assert (h, c) == ("tsdiff.pack.host", "tsdiff.pack.copy") and h1 <= c0


@pytest.mark.parametrize("device_data", ["on", "off"])
def test_train_run_records_data_and_step_once_an_iteration(tmp_path, device_data):
    cfg = tiny_config(str(tmp_path), max_iters=3, val_freq=3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_cli.main([cfg, "--logdir", str(tmp_path / "logs"), "--device", "cpu",
                        "--device_data", device_data])
    names = [n for n, _, _ in spans(prof, "tsdiff.train.")]
    assert names.count("tsdiff.train.data") == 3 and names.count("tsdiff.train.step") == 3
    assert set(names) == {"tsdiff.train.data", "tsdiff.train.step"}     # no graphs on the CPU


def test_nan_rounds_counted_and_reported_by_healthz(ckpts):  # noqa: F811
    runner, batch = small_runner()
    noise = torch.zeros((runner.n_walk, *batch.pos.shape))
    _, nan = runner.run(batch, torch.full(batch.pos.shape, float("nan")), noise)
    assert nan and runner.nan_rounds == 1
    _, nan = runner.run(batch, torch.zeros(batch.pos.shape), noise)
    assert not nan and runner.nan_rounds == 1 and runner.rounds() == {3: 2}

    svc = service(ckpts[:1], fused_score=True)
    httpd = serve.make_http_server(svc, "127.0.0.1", free_port())
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        graphs = make_graph_dicts(np.random.default_rng(4), [6], feat_dim=MODEL_CFG.feat_dim)
        nan_batch = from_numpy_graphs(graphs, max_nodes=8)
        walker = svc._runner((8, 0))
        pos_init = torch.full(nan_batch.pos.shape, float("nan"))
        _, nan = walker.run(nan_batch, pos_init, torch.Generator().manual_seed(0))
        assert nan
        url = f"http://127.0.0.1:{httpd.server_address[1]}/healthz"
        with urllib.request.urlopen(url, timeout=10) as r:
            health = json.load(r)
        assert health["nan_rounds"] == 1
    finally:
        httpd.shutdown()
        svc.close()
        thread.join(timeout=10)
    assert not thread.is_alive()
