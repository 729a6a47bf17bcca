"""The port's serving entry point (``tsdiff_tpu_torch/serve.py``) on the CPU,
against the JAX package's ``tsdiff_tpu/serve.py``.

* Tier planning: ``_plan_tiers`` equals JAX's for every n in 0..300 at three
  ``max_batch`` values.
* One served round equals the JAX service's ``_execute`` on the same padded
  batch, in float32 with ``fused_score``, for the full and the draft tier.
  JAX draws its start from ``fold_in(key, 1)`` and walks with
  ``fold_in(key, 2)``, whose scan noise is ``fold_in(key_scan, k)`` after
  ``split``, with ``key = key(seed * 7919 + served)``; the test rebuilds both
  and feeds them to the port's walk.  Tolerance rtol=5e-4, atol=5e-5, as in
  ``test_torch_sampler.py``: float32 sums in another order.
* The factored walk step: ``dynamic_sampling`` and the service's walk on its
  own buffers (``diffusion/captured.py``, run eagerly: graphs need a card)
  equal, bit for bit, a loop with the coefficients as Python floats, the
  sampler's update before the step was factored out.
* The service's semantics, one test each as in ``tests/test_serve.py``:
  buckets and runners, the draft tier, the HTTP front end, backpressure and
  its 503, the feature-width check, deadlines and cancellation, the worker's
  survival, ``close(drain)``, and the clip-20 retry on NaN; the JAX flags
  that are not ported are refused.

Checkpoints are written by the JAX package, as ``tests/test_serve.py`` writes
them; services here run on the CPU with ``capture=False``.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tsdiff_tpu.config import Config
from tsdiff_tpu.core.graph import from_numpy_graphs as jax_from_numpy_graphs
from tsdiff_tpu.serve import SamplerService as JaxService
from tsdiff_tpu.train import save_checkpoint
from tsdiff_tpu.train.trainer import TrainState

from tsdiff_tpu_torch import serve
from tsdiff_tpu_torch.core.graph import from_numpy_graphs
from tsdiff_tpu_torch.diffusion import captured
from tsdiff_tpu_torch.diffusion.ensemble import make_ensemble, make_packed_ensemble_eps_fn
from tsdiff_tpu_torch.diffusion.sampler import (
    SamplingSettings,
    build_step_coeffs,
    dynamic_sampling,
    initial_position,
)
from tsdiff_tpu_torch.core.geometry import center_pos, clip_norm, eq_transform
from tsdiff_tpu_torch.serve import SamplerService, ServiceOverloaded

from test_condensenc import MODEL_CFG, make_batch
from test_data import make_graph_dicts
from test_torch_common import close, small_setup

FEAT = MODEL_CFG.feat_dim


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Two tiny members (H=32, L=2) written by the JAX package."""
    from tsdiff_tpu.models import get_model

    root = tmp_path_factory.mktemp("torch_serve")
    rng = np.random.default_rng(0)
    batch = make_batch(rng, [5, 6], n_pad=8)
    model = get_model(MODEL_CFG)
    paths = []
    for m in range(2):
        params = model.init(
            jax.random.key(m), batch.atom_type, batch.r_feat, batch.p_feat,
            batch.pos, batch.bond_mat, batch.node_mask,
        )
        p = str(root / f"{m}.ckpt")
        save_checkpoint(
            p, Config(model=MODEL_CFG.to_dict()),
            TrainState(params=params, opt_state=None, step=jnp.asarray(0)),
        )
        paths.append(p)
    return paths


def service(ckpts, **kw):
    kw = {"n_steps": 4, "dtype": "float32", "max_batch": 4, "device": "cpu",
          "capture": False, **kw}
    return SamplerService(ckpts, **kw)


# -- parity with the JAX service ---------------------------------------------


def _planner(cls, max_batch):
    svc = cls.__new__(cls)
    svc.max_batch = max_batch
    svc._dp = 1
    return svc


@pytest.mark.parametrize("max_batch", [4, 32, 100])
def test_plan_tiers_match_jax(max_batch):
    port, ref = _planner(SamplerService, max_batch), _planner(JaxService, max_batch)
    assert port._tier_ladder() == ref._tier_ladder()
    for n in range(0, 301):
        assert port._plan_tiers(n) == ref._plan_tiers(n), n
        assert port._batch_tier(n) == ref._batch_tier(n), n


@pytest.mark.parametrize("respacing", [0, 3], ids=["full", "draft"])
def test_served_round_matches_jax(ckpts, respacing):
    rng = np.random.default_rng(21)
    graphs = make_graph_dicts(rng, [5, 7, 6], feat_dim=FEAT)
    tier, bucket = 4, 8
    gpad = graphs + [graphs[-1]] * (tier - len(graphs))
    kw = dict(n_steps=8, dtype="float32", fused_score=True, max_batch=4, draft_respacing=3)
    ref_svc = JaxService(ckpts, **kw)
    try:
        ref_pos, ref_nan = ref_svc._execute(
            bucket, tier, jax_from_numpy_graphs(gpad, max_nodes=bucket), respacing)
    finally:
        ref_svc.close()

    svc = service(ckpts, **kw)
    try:
        runner = svc._runner((bucket, respacing))
        key = jax.random.key(svc.seed * 7919 + svc._served)
        pos_init = np.array(jax.random.normal(jax.random.fold_in(key, 1), (tier, bucket, 3)))
        _, key_scan = jax.random.split(jax.random.fold_in(key, 2))
        noise = np.stack([
            np.asarray(jax.random.normal(jax.random.fold_in(key_scan, k), (tier, bucket, 3)))
            for k in range(runner.n_walk)
        ])
        assert runner.n_walk == (respacing or 8)
        pos, nan = runner.run(from_numpy_graphs(gpad, max_nodes=bucket),
                              torch.from_numpy(pos_init), torch.from_numpy(noise))
    finally:
        svc.close()
    assert not ref_nan and not nan
    assert pos.shape == (tier, bucket, 3) and pos.dtype == np.float32
    close(pos, ref_pos)
    # the walk moved the start well beyond the tolerance
    assert np.abs(pos - pos_init).max() > 1e-2


# -- the factored walk step ----------------------------------------------------


def float_coefficient_walk(score_fn, schedule, pos_init, node_mask, settings, noise):
    """The sampler's loop as it was before the step was factored out: the
    coefficients as Python floats, read on the host."""
    coeffs = build_step_coeffs(schedule, settings)
    pos = initial_position(schedule, settings, pos_init)
    pos = pos * node_mask[..., None].to(pos.dtype)
    for k in range(len(coeffs.a)):
        if getattr(score_fn, "returns_node_eq", False):
            node_eq = score_fn(pos)
        else:
            edge_inv, emask, d = score_fn(pos)
            node_eq = eq_transform(edge_inv, pos, emask, d)
        eps_pos = clip_norm(node_eq, limit=settings.clip)
        pos = float(coeffs.a[k]) * pos + float(coeffs.b[k]) * eps_pos \
            + float(coeffs.c[k]) * noise[k]
        pos = center_pos(pos, node_mask)
    return pos


@pytest.mark.parametrize("fused", [True, False], ids=["packed", "dense"])
@pytest.mark.parametrize("rule,respacing", [("ld", None), ("ld", 3), ("ddpm", None),
                                            ("generalized", 4)])
def test_walk_step_equals_float_coefficient_loop(fused, rule, respacing):
    from tsdiff_tpu_torch.config import Config as TConfig
    from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule

    _, _, _, tmodels, tb, _ = small_setup(seed=4, sizes=(5, 8, 11), n_pad=12, members=2)
    for m in tmodels:
        m.fused_score = fused
    schedule = DiffusionSchedule.from_config(TConfig(MODEL_CFG))
    settings = SamplingSettings(sampling_type=rule, n_steps=10, step_lr=1e-5,
                                timestep_respacing=respacing)
    n_walk = len(build_step_coeffs(schedule, settings).a)
    gen = torch.Generator().manual_seed(3)
    pos_init = torch.randn(tb.pos.shape, generator=gen)
    noise = torch.randn((n_walk, *tb.pos.shape), generator=gen)
    ensemble = make_ensemble(tmodels)
    ref = float_coefficient_walk(ensemble.step_fn(ensemble.prepare(tb)), schedule, pos_init,
                                 tb.node_mask, settings, noise)
    out = dynamic_sampling(ensemble.step_fn(ensemble.prepare(tb)), schedule, pos_init,
                           tb.node_mask, settings, noise=noise)
    assert torch.equal(out.pos, ref)
    # the service's walk on its own buffers, twice: the second round copies
    # the batch's statics into the first round's tensors
    runner = captured.WalkRunner(ensemble, schedule, settings, capture=False)
    scale = runner.scale
    for _ in range(2):
        pos, nan = runner.run(tb, pos_init, noise)
        assert not nan
        np.testing.assert_array_equal(pos, (ref * scale).numpy())
    assert runner.captures == 0 and list(runner._tiers) == [tb.pos.shape[0]]


def test_runner_fills_its_noise_from_the_generator():
    """Given a generator, a round fills its noise buffer in place with what
    ``torch.randn`` of the round's noise shape draws from the same state."""
    from tsdiff_tpu_torch.config import Config as TConfig
    from tsdiff_tpu_torch.diffusion.ensemble import PackedEnsemble
    from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule

    _, _, _, tmodels, tb, _ = small_setup(seed=4, sizes=(5, 8, 11), n_pad=12, members=2)
    schedule = DiffusionSchedule.from_config(TConfig(MODEL_CFG))
    settings = SamplingSettings(n_steps=6)
    pos_init = torch.randn(tb.pos.shape, generator=torch.Generator().manual_seed(5))
    noise = torch.randn((6, *tb.pos.shape), generator=torch.Generator().manual_seed(8))
    runner = captured.WalkRunner(PackedEnsemble(tmodels), schedule, settings, capture=False)
    ref, _ = runner.run(tb, pos_init, noise)
    pos, _ = runner.run(tb, pos_init, torch.Generator().manual_seed(8))
    assert torch.equal(runner._tiers[tb.pos.shape[0]].noise, noise)
    np.testing.assert_array_equal(pos, ref)


def test_runner_statics_follow_the_batch():
    """A second batch of the same shape through the same buffers gives what
    a fresh walk on it gives: the step reads the statics the round copied."""
    from tsdiff_tpu_torch.config import Config as TConfig
    from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule

    _, _, _, tmodels, tb, _ = small_setup(seed=4, sizes=(5, 8, 11), n_pad=12, members=2)
    _, _, _, _, tb2, _ = small_setup(seed=9, sizes=(9, 6, 12), n_pad=12, members=1)
    schedule = DiffusionSchedule.from_config(TConfig(MODEL_CFG))
    settings = SamplingSettings(n_steps=6)
    gen = torch.Generator().manual_seed(5)
    pos_init = torch.randn(tb.pos.shape, generator=gen)
    noise = torch.randn((6, *tb.pos.shape), generator=gen)
    from tsdiff_tpu_torch.diffusion.ensemble import PackedEnsemble

    ensemble = PackedEnsemble(tmodels)
    runner = captured.WalkRunner(ensemble, schedule, settings, capture=False)
    runner.run(tb, pos_init, noise)
    pos2, _ = runner.run(tb2, pos_init, noise)
    fresh = dynamic_sampling(make_packed_ensemble_eps_fn(tmodels, tb2), schedule, pos_init,
                             tb2.node_mask, settings, noise=noise)
    np.testing.assert_array_equal(pos2, (fresh.pos * runner.scale).numpy())


def test_copy_into_checks_shapes():
    from tsdiff_tpu_torch.diffusion.ensemble import DenseStatics

    dst = DenseStatics(node_mask=torch.zeros(2, 3), members=[torch.zeros(4), None])
    captured.copy_into(dst, DenseStatics(torch.ones(2, 3), [torch.full((4,), 2.0), None]))
    assert dst.node_mask.sum() == 6 and dst.members[0].sum() == 8
    for bad in (DenseStatics(torch.ones(3, 3), [torch.zeros(4), None]),
                DenseStatics(torch.ones(2, 3, dtype=torch.float64), [torch.zeros(4), None]),
                DenseStatics(torch.ones(2, 3), [torch.zeros(4)])):
        with pytest.raises(ValueError, match="cannot copy"):
            captured.copy_into(dst, bad)
    with pytest.raises(TypeError, match="cannot copy"):
        captured.copy_into(dst, DenseStatics(torch.ones(2, 3), [torch.zeros(4), torch.zeros(1)]))


# -- service semantics, as tests/test_serve.py checks the JAX service -----------


def test_service_batches_and_resolves(ckpts):
    rng = np.random.default_rng(1)
    graphs = make_graph_dicts(rng, [5, 7, 6, 12], feat_dim=FEAT)
    svc = service(ckpts, max_wait_s=0.2)
    try:
        results = svc.generate(graphs)
        assert len(results) == 4
        for g, r in zip(graphs, results):
            n = len(g["atom_type"])
            assert r["pos_gen"].shape == (n, 3) and r["pos_gen"].dtype == np.float32
            assert np.isfinite(r["pos_gen"]).all()
            assert r["nan"] is False
        # sizes 5/7/6 share the N=8 bucket; 12 lands in N=16 -> 2 walks
        assert set(svc._runners) == {(8, 0), (16, 0)}
        assert svc._served == 4
        assert svc._graphs_captured == 0
    finally:
        svc.close()


def test_service_draft_quality_tier(ckpts):
    rng = np.random.default_rng(3)
    graphs = make_graph_dicts(rng, [5, 6, 7, 6], feat_dim=FEAT)
    svc = service(ckpts[:1], n_steps=8, max_wait_s=0.2, draft_respacing=2, fused_score=True)
    try:
        futs = [
            svc.submit(graphs[0], quality="full"),
            svc.submit(graphs[1], quality="draft"),
            svc.submit(graphs[2], quality="draft"),
            svc.submit(graphs[3], quality="full"),
        ]
        for g, f in zip(graphs, futs):
            r = f.result(timeout=120)
            assert r["pos_gen"].shape == (len(g["atom_type"]), 3)
            assert np.isfinite(r["pos_gen"]).all()
        assert set(svc._runners) == {(8, 0), (8, 2)}
        assert svc._runners[(8, 2)].n_walk == 2 and svc._runners[(8, 0)].n_walk == 8
    finally:
        svc.close()

    svc2 = service(ckpts[:1], n_steps=8)
    try:
        with pytest.raises(ValueError, match="no draft tier"):
            svc2.submit(graphs[0], quality="draft")
        with pytest.raises(ValueError, match="quality must be"):
            svc2.submit(graphs[0], quality="fast")
    finally:
        svc2.close()
    with pytest.raises(ValueError, match="draft_respacing"):
        service(ckpts[:1], n_steps=8, draft_respacing=9)


def free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def wait_healthy(port):
    for _ in range(150):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=1) as r:
                return json.load(r)
        except OSError:
            time.sleep(0.2)
    raise RuntimeError("server did not come up")


def post(port, payload: bytes, path="/generate"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=payload,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def graph_json(g) -> dict:
    return {
        "atom_type": np.asarray(g["atom_type"]).tolist(),
        "r_feat": np.asarray(g["r_feat"]).tolist(),
        "p_feat": np.asarray(g["p_feat"]).tolist(),
        "pos": None,
        "edge_index": np.asarray(g["edge_index"]).tolist(),
        "edge_type": np.asarray(g["edge_type"]).tolist(),
    }


def test_http_front_end(ckpts):
    rng = np.random.default_rng(2)
    g = make_graph_dicts(rng, [6], feat_dim=FEAT)[0]
    port = free_port()
    t = threading.Thread(
        target=serve.main,
        args=([ckpts[0], "--port", str(port), "--n_steps", "3", "--dtype", "float32",
               "--max_batch", "2", "--max_wait_ms", "20", "--device", "cpu",
               "--fused_score"],),
        daemon=True,
    )
    t.start()
    assert wait_healthy(port)["ok"] is True
    code, out = post(port, json.dumps({"graphs": [graph_json(g)]}).encode())
    assert code == 200
    pos = np.asarray(out["pos_gen"][0])
    assert pos.shape == (6, 3) and np.isfinite(pos).all()
    assert out["nan"] == [False]
    # malformed request -> 400 with an error body, server stays up
    code, out = post(port, b"{}")
    assert code == 400 and "error" in out
    code, out = post(port, b"{}", path="/nothing")
    assert code == 404
    health = wait_healthy(port)
    assert health["served"] >= 1
    # the JAX service's keys, and the rounds flagged NaN
    assert set(health) == {"ok", "served", "pending", "timed_out", "cancelled", "rejected",
                           "nan_rounds"}
    assert health["nan_rounds"] == 0


@pytest.mark.parametrize("flags,match", [
    (["--mesh", "4,2"], "--mesh"),
    (["--multihost"], "--multihost"),
    (["--coordinator", "127.0.0.1:1234", "--nprocs", "2", "--procid", "0"], "--coordinator"),
    (["--compile_cache", "cache"], "_build"),
])
def test_cli_refuses_what_is_not_ported(ckpts, flags, match):
    """The compile cache is ported (tests/test_torch_compile_cache.py) and
    parses; the mesh flags are ported (tests/test_torch_parallel.py) and
    refuse what cannot run: a mesh without the ranks for it, --multihost
    without a mesh, cluster flags without --multihost."""
    if flags[0] == "--compile_cache":
        assert serve.parse_args([ckpts[0], *flags]).compile_cache == flags[1]
        return
    with pytest.raises(SystemExit, match=match) as e:
        serve.parse_args([ckpts[0], *flags])
    if match != "_build":
        assert "ROADMAP A.5" not in str(e.value)
        assert any(w in str(e.value) for w in ("ranks", "--multihost"))


def test_cuda_default_raises_without_a_card(ckpts):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is exercised by chip_smoke.py")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SamplerService(ckpts[:1], n_steps=4, dtype="float32")
    with pytest.raises(ValueError, match="capture=False"):
        SamplerService(ckpts[:1], n_steps=4, dtype="float32", device="cpu")
    with pytest.raises(ValueError, match="quant requires fused_score"):
        service(ckpts[:1], quant="int8")


@pytest.fixture
def gated_service(ckpts, monkeypatch):
    """Service whose _run_group blocks on an event — deterministic queue
    states without device timing."""
    gate = threading.Event()
    ran = []

    def fake_run_group(self, bucket, group, tier, respacing=0):
        assert gate.wait(60), "test gate never opened"
        for r in group:
            if not r.future.done():
                r.future.set_result(
                    {"pos_gen": np.zeros((r.n_atoms, 3), np.float32), "nan": False}
                )
        self._served += len(group)
        ran.append((bucket, tier, len(group)))

    monkeypatch.setattr(SamplerService, "_run_group", fake_run_group)
    svc = service(ckpts[:1], n_steps=2, max_batch=2, max_wait_s=0.05, max_pending=2)
    # hand the worker its first request so the queue is exclusively ours
    first = svc.submit(make_graph_dicts(np.random.default_rng(9), [5], feat_dim=FEAT)[0])
    for _ in range(200):
        if svc._q.qsize() == 0 and first.running():
            break
        time.sleep(0.02)
    assert first.running(), "worker did not pick up the priming request"
    yield svc, gate, ran, first
    gate.set()
    svc.close()


def test_backpressure_rejects_when_full(gated_service):
    svc, gate, _, first = gated_service
    rng = np.random.default_rng(10)
    gs = make_graph_dicts(rng, [5, 5, 5, 5], feat_dim=FEAT)
    f1 = svc.submit(gs[0])
    f2 = svc.submit(gs[1])
    with pytest.raises(ServiceOverloaded):
        svc.submit(gs[2])
    assert svc._rejected == 1
    # the HTTP front answers the same full queue with a 503
    httpd = serve.make_http_server(svc, "127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        code, out = post(httpd.server_address[1],
                         json.dumps({"graphs": [graph_json(gs[3])]}).encode())
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
    assert code == 503 and out["error"].startswith("overloaded")
    assert svc._rejected == 2 and not t.is_alive()
    gate.set()
    assert f1.result(timeout=60)["pos_gen"].shape == (5, 3)
    assert f2.result(timeout=60)["nan"] is False
    assert first.result(timeout=60) is not None


def test_submit_validates_feat_width(ckpts):
    svc = service(ckpts[:1], fused_score=True)
    try:
        rng = np.random.default_rng(0)
        bad = make_graph_dicts(rng, [5], feat_dim=FEAT + 3)[0]
        with pytest.raises(ValueError, match="feat_dim"):
            svc.submit(bad)
        empty = dict(make_graph_dicts(rng, [5], feat_dim=FEAT)[0])
        empty.update(atom_type=np.zeros(0, np.int32), r_feat=np.zeros((0, FEAT), np.float32),
                     p_feat=np.zeros((0, FEAT), np.float32))
        with pytest.raises(ValueError, match="empty graph"):
            svc.submit(empty)
        # a well-formed request still serves afterwards
        ok = make_graph_dicts(rng, [5], feat_dim=FEAT)[0]
        assert svc.submit(ok).result(timeout=120)["pos_gen"].shape == (5, 3)
    finally:
        svc.close(drain=False)


def test_timeout_and_cancel(gated_service):
    svc, gate, ran, first = gated_service
    rng = np.random.default_rng(11)
    gs = make_graph_dicts(rng, [6, 6], feat_dim=FEAT)
    f_timeout = svc.submit(gs[0], timeout_s=0.01)
    f_cancel = svc.submit(gs[1])
    assert f_cancel.cancel()
    time.sleep(0.05)  # let the deadline expire while queued
    gate.set()
    with pytest.raises(TimeoutError):
        f_timeout.result(timeout=60)
    assert f_cancel.cancelled()
    first.result(timeout=60)
    for _ in range(200):
        if svc._timed_out and svc._cancelled:
            break
        time.sleep(0.02)
    assert svc._timed_out == 1 and svc._cancelled == 1
    # neither shed request occupied a batch slot
    assert all(n <= 1 for _, _, n in ran)


def test_worker_survives_cancelled_expired_request(gated_service):
    svc, gate, _, first = gated_service
    rng = np.random.default_rng(12)
    gs = make_graph_dicts(rng, [6, 6], feat_dim=FEAT)
    f_both = svc.submit(gs[0], timeout_s=0.01)
    assert f_both.cancel()
    time.sleep(0.05)  # deadline expires while the request is still queued
    gate.set()
    first.result(timeout=60)
    assert f_both.cancelled()
    f_after = svc.submit(gs[1])
    assert f_after.result(timeout=60)["pos_gen"].shape == (6, 3)
    assert svc._worker.is_alive()


@pytest.mark.parametrize("drain", [True, False], ids=["drain", "cancel"])
def test_close_drains_or_cancels_queued_requests(ckpts, monkeypatch, drain):
    gate = threading.Event()
    ran = []

    def fake_run_group(self, bucket, group, tier, respacing=0):
        assert gate.wait(60), "test gate never opened"
        for r in group:
            if not r.future.done():
                r.future.set_result(
                    {"pos_gen": np.zeros((r.n_atoms, 3), np.float32), "nan": False}
                )
        ran.append(len(group))

    monkeypatch.setattr(SamplerService, "_run_group", fake_run_group)
    svc = service(ckpts[:1], n_steps=2, max_batch=4, max_wait_s=0.01)
    graphs = make_graph_dicts(np.random.default_rng(12), [5] * 7, feat_dim=FEAT)
    first = svc.submit(graphs[0])
    for _ in range(200):   # the worker holds the first round at the gate
        if first.running() and svc._q.qsize() == 0:
            break
        time.sleep(0.02)
    futs = [svc.submit(g) for g in graphs[1:]]
    closer = threading.Thread(target=svc.close, kwargs={"drain": drain})
    closer.start()
    for _ in range(200):   # close() has flushed (or not) and queued its sentinel
        if svc._closed and svc._q.qsize() == (7 if drain else 1):
            break
        time.sleep(0.02)
    gate.set()
    closer.join(timeout=60)
    assert not closer.is_alive() and not svc._worker.is_alive()
    assert first.result(timeout=1)["nan"] is False
    if drain:
        assert all(f.result(timeout=1)["nan"] is False for f in futs)
        assert sum(ran) == 7
    else:
        assert all(f.cancelled() for f in futs)
        assert svc._cancelled == 6 and sum(ran) == 1
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(graphs[0])


@pytest.mark.parametrize("clip", [1000.0, 20.0], ids=["retried", "at_20_already"])
def test_nan_retries_once_at_clip_20(ckpts, monkeypatch, clip):
    """A round whose walk reports NaN runs once more on the retry walk at
    clip 20 (its own runner, keyed as JAX keys it), with fresh noise and the
    same start; a service already at clip 20 does not retry."""
    calls = []
    real_run = captured.WalkRunner.run

    def run(self, batch, pos_init, noise):
        pos, _ = real_run(self, batch, pos_init, noise)
        walked = self._tiers[pos_init.shape[0]].noise       # the round's noise buffer
        calls.append((self.settings.clip, pos_init.clone(), walked.clone()))
        return pos, self.settings.clip > 20.0   # NaN reported at the service's clip only

    monkeypatch.setattr(captured.WalkRunner, "run", run)
    svc = service(ckpts[:1], clip=clip, fused_score=True)
    try:
        g = make_graph_dicts(np.random.default_rng(4), [6], feat_dim=FEAT)[0]
        out = svc.submit(g).result(timeout=120)
    finally:
        svc.close()
    if clip > 20.0:
        assert [c for c, _, _ in calls] == [1000.0, 20.0]
        assert set(svc._runners) == {(8, 0), (8, 0, "retry")}
        assert svc._runners[(8, 0, "retry")].settings.clip == 20.0
        assert torch.equal(calls[0][1], calls[1][1])
        assert not torch.equal(calls[0][2], calls[1][2])
        assert out["nan"] is False
    else:
        assert [c for c, _, _ in calls] == [20.0]
        assert set(svc._runners) == {(8, 0)}
        assert out["nan"] is False


def test_service_takes_orbax_members(ckpts, tmp_path):
    """The JAX-written members rewritten as ``.orbax`` directories by the
    port's writer: a served round from them equals one from the ``.ckpt``
    files, bit for bit."""
    from tsdiff_tpu_torch.train import load_checkpoint
    from tsdiff_tpu_torch.train.orbax_io import write_checkpoint_orbax

    dirs = []
    for i, path in enumerate(ckpts):
        dirs.append(str(tmp_path / f"{i}.orbax"))
        write_checkpoint_orbax(dirs[-1], load_checkpoint(path))
    graphs = make_graph_dicts(np.random.default_rng(4), [5, 7, 6], feat_dim=FEAT)
    tier, bucket = 4, 8
    gpad = graphs + [graphs[-1]] * (tier - len(graphs))
    rounds = []
    for members in (ckpts, dirs):
        svc = service(members, fused_score=True)
        try:
            rounds.append(svc._execute(bucket, tier, from_numpy_graphs(gpad, max_nodes=bucket)))
        finally:
            svc.close()
    (pos_ck, nan_ck), (pos_ox, nan_ox) = rounds
    assert not bool(np.asarray(nan_ck).any()) and np.isfinite(np.asarray(pos_ck)).all()
    np.testing.assert_array_equal(np.asarray(pos_ox), np.asarray(pos_ck))
    np.testing.assert_array_equal(np.asarray(nan_ox), np.asarray(nan_ck))
