"""The port's (dp, ens) mesh on the CPU: two Gloo ranks against the JAX
package's unsharded functions and against the port's own one-rank runs.

One module fixture starts two ranks (this file run as a script with
``<rank> <port> <dir>``), each joining a Gloo process group on a free local port, and runs one
programme of phases in both; rank 0 (and rank 1 where it says) writes what
it saw to a pickle.  The JAX references and the one-rank runs are made in
the test process.  Timeouts: the ranks' collectives and rendezvous give up
after ``COLLECTIVE_TIMEOUT_S``, and the two processes are killed after
``RANKS_TIMEOUT_S``, so a hang fails the fixture's tests, not the suite.

(a) the member split, mesh (1, 2): each rank loads 2 of the 4 members, and
    the packed (``PackedEnsemble``) and the dense ensemble's score on an
    injected ``pos`` equal JAX's unsharded ``make_ensemble_score_fn`` over
    all 4 at rtol 1e-5 (f32; the member sum reduced across the ranks adds in
    another order than one mean);
(b) the data-parallel train step, mesh (2, 1), on shards of unequal atom
    counts (a per-rank mean averaged over the ranks would be wrong): the
    loss, every gradient (the all-reduced one the optimizer sees) and the
    updated parameters against JAX's jitted step on the whole batch, at the
    slice's rtol 5e-4, atol 5e-5, for the dense objective through B3's
    plain twin (``use_pallas``) and the ``packed_train`` objective;
(c) the sampling CLI with ``--mesh 1,2`` and ``2,1`` writes the samples of
    the one-rank CLI of the same seed (rtol 1e-5: the member sum's order),
    and only rank 0 writes;
(d) the train CLI under ``--multihost`` (the resident corpus, the streamed
    loader, ``--mesh_layout hybrid`` over two one-rank nodes) logs the
    one-rank run's losses (train loss as printed, validation loss within
    1e-4 relative), rank 0 alone writes checkpoints, rank 1 logs to its own
    ``_proc1`` directory;
(e) a served round (rank 0 batching, rank 1 in ``worker_loop``) on meshes
    (2, 1) and (1, 2) equals the one-rank service's round;
(f) the JAX CLIs' mesh checks in a world of two ranks and in one process;
    the mesh's coordinates and groups, ``replicate_output`` and the other
    ``parallel/multihost.py`` helpers; the capture choice by backend.
"""

import glob
import os
import pickle
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
WORLD = 2
RANKS_TIMEOUT_S = 300
COLLECTIVE_TIMEOUT_S = 120
SAMPLE_FLAGS = ["--n_steps", "6", "--batch_size", "2", "--device", "cpu", "--sort_by_size",
                "--fused_score"]
TRAIN_CASES = {"resident": [], "streamed": ["--device_data", "off"],
               "hybrid": ["--mesh_layout", "hybrid"]}
SERVE_MESHES = ((2, 1), (1, 2))
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6
RTOL, ATOL = 5e-4, 5e-5
LR = 5e-4


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def exit_message(fn) -> str | None:
    try:
        fn()
    except (SystemExit, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return None


# -- the ranks' programme (no JAX here: the ranks import the port alone) ------


def rank_main(rank: int, port: int, d: str) -> None:
    sys.path[:0] = [REPO, TESTS]
    torch.set_num_threads(1)
    from tsdiff_tpu_torch.cli import sampling
    from tsdiff_tpu_torch.cli import train as train_cli
    from tsdiff_tpu_torch.config import Config
    from tsdiff_tpu_torch.core.graph import from_numpy_graphs
    from tsdiff_tpu_torch.diffusion.ensemble import load_members, make_ensemble
    from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
    from tsdiff_tpu_torch.models import CondenseEncoderEpsNetwork
    from tsdiff_tpu_torch.parallel import make_mesh, multihost, replicate
    from tsdiff_tpu_torch.parallel.sharding import batch_spec, make_hybrid_mesh, take
    from tsdiff_tpu_torch.serve import SamplerService
    from tsdiff_tpu_torch.train import init_train_state, make_optimizer, make_train_step

    with open(os.path.join(d, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    coordinator = f"127.0.0.1:{port}"
    cluster = ["--multihost", "--coordinator", coordinator, "--nprocs", str(WORLD),
               "--procid", str(rank)]
    multihost.initialize(coordinator, WORLD, rank, device="cpu")
    out: dict = {}

    # (f) the meshes: coordinates, groups, replicate_output
    for shape in ((2, 1), (1, 2)):
        mesh = make_mesh(*shape, device="cpu")
        full = multihost.replicate_output(torch.full((3, 2), float(rank + 1)), mesh)
        out[f"mesh_{shape}"] = dict(coords=mesh.coords, dp_index=mesh.dp_index, dp=mesh.dp,
                                    ens=mesh.ens, backend=mesh.backend, full=full.numpy())
    mesh = make_mesh(2, 1, device="cpu")
    ones = torch.full((2,), float(rank))
    replicate(ones, mesh)   # rank 0's values on every rank
    out["helpers"] = dict(
        replicated=ones.tolist(),
        draw=torch.randn(4, generator=multihost.global_key(7, mesh)).tolist(),
        rows=multihost.make_global_batch(np.arange(8).reshape(4, 2), mesh).tolist(),
        whole=multihost.make_replicated({"a": np.arange(3)}, mesh)["a"].tolist())
    hybrid = make_hybrid_mesh(ens=1, device="cpu")
    x = torch.tensor([float(rank + 1)])
    torch.distributed.all_reduce(x, group=hybrid.data_group)
    out["mesh_hybrid"] = dict(shape=hybrid.shape, coords=hybrid.coords, dp=hybrid.dp,
                              dp_index=hybrid.dp_index, data_sum=float(x))

    # (a) the member split
    mesh = make_mesh(1, 2, device="cpu")
    batch = from_numpy_graphs(inp["graphs"], max_nodes=12)
    pos = torch.from_numpy(inp["pos"])
    for kind, fused in (("packed", True), ("dense", False)):
        members, _ = load_members(inp["ckpts"], "cpu", torch.float32, fused_score=fused,
                                  mesh=mesh)
        ensemble = make_ensemble(members, mesh)
        score = ensemble.step_fn(ensemble.prepare(batch))(pos)
        out[f"score_{kind}"] = dict(members=len(members), n_members=ensemble.n_members,
                                    score=(score if fused else score[0]).numpy())

    # (b) the data-parallel train step
    mesh = make_mesh(2, 1, device="cpu")
    for name, case in inp["train"].items():
        cfg = Config(case["cfg"])
        model = CondenseEncoderEpsNetwork.from_config(cfg)
        model.load_state_dict(case["state"])
        tx = make_optimizer(Config(case["opt"]), 3000.0)
        seen = {}
        update = tx.update

        def spy(grads, opt_state, params, update=update, seen=seen):
            seen.update({k: g.clone() for k, g in grads.items()})
            return update(grads, opt_state, params)

        tx.update = spy
        step = make_train_step(model, tx, DiffusionSchedule.from_config(cfg), mesh=mesh)
        local = from_numpy_graphs(take(case["graphs"], batch_spec(mesh)), max_nodes=12)
        state, metrics = step(init_train_state(model, tx), local, LR, t=case["t"],
                              noise=case["noise"])
        out[f"train_{name}"] = dict(
            local_nodes=int(local.node_mask.sum()),
            metrics={k: float(v) for k, v in metrics.items()},
            grads={k: g.numpy() for k, g in seen.items()},
            params={k: p.detach().numpy().copy() for k, p in state.params.items()},
        )

    # (c) the sampling CLI
    for flag in ("1,2", "2,1"):
        save = os.path.join(d, f"sample_{flag}", f"rank{rank}")
        out[f"sample_{flag}"] = sampling.main(
            inp["ckpts"] + ["--test_set", inp["test_set"], "--save_dir", save, *SAMPLE_FLAGS,
                            "--mesh", flag, *cluster])

    # (d) the train CLI
    for case, flags in TRAIN_CASES.items():
        out[f"train_cli_{case}"] = train_cli.main(
            [inp["train_cfg"], "--logdir", os.path.join(d, f"train_{case}"), "--device", "cpu",
             *flags, *cluster])

    # (e) serving
    for shape in SERVE_MESHES:
        svc = SamplerService(inp["ckpts"], n_steps=6, dtype="float32", max_batch=4,
                             fused_score=True, device="cpu", capture=False,
                             mesh=make_mesh(*shape, device="cpu"))
        if rank == 0:
            results = svc.generate(inp["graphs"][:3])
            svc.close()
            out[f"serve_{shape}"] = [r["pos_gen"] for r in results]
        else:
            svc.worker_loop()

    # (f) the CLIs' checks in a world of two ranks (each raises before any
    # collective, on both ranks alike)
    base = ["--test_set", inp["test_set"], "--save_dir", os.path.join(d, "refused"),
            *SAMPLE_FLAGS]
    out["checks"] = {
        "sampling_mesh_short": exit_message(lambda: sampling.main(
            inp["ckpts"] + base + ["--mesh", "1,1", *cluster])),
        "sampling_ens_indivisible": exit_message(lambda: sampling.main(
            inp["ckpts"][:3] + base + ["--mesh", "1,2", *cluster])),
        "train_batch_indivisible": exit_message(lambda: train_cli.main(
            [inp["train_cfg_b3"], "--logdir", os.path.join(d, "refused"), "--device", "cpu",
             *cluster])),
        "serve_without_mesh": exit_message(lambda: SamplerService(
            inp["ckpts"], n_steps=6, dtype="float32", fused_score=True, device="cpu",
            capture=False)),
    }
    torch.distributed.destroy_process_group()
    with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# -- the test process: inputs, the two ranks, the references -----------------


def write_inputs(d: str) -> dict:
    import jax

    from tsdiff_tpu_torch.convert import params_from_jax
    from tsdiff_tpu_torch.data.dataset import save_dataset
    from tsdiff_tpu_torch.data.synthetic import sparse_edges

    from test_condensenc import MODEL_CFG
    from test_torch_common import make_graphs, small_setup
    from test_torch_train import jax_draws, tiny_config

    jmodel, params, jb, _, _, graphs = small_setup(seed=6, sizes=(5, 9, 7, 6, 8), members=4)
    ckpts = []
    for m, p in enumerate(params):
        path = os.path.join(d, f"m{m}.ckpt")
        with open(path, "wb") as f:
            pickle.dump({"format": "tsdiff_tpu.ckpt.v1", "config": {"model": MODEL_CFG.to_dict()},
                         "params": jax.device_get(p), "ema_params": None}, f)
        ckpts.append(path)
    for i, g in enumerate(graphs):
        g["smiles"] = f"g{i}"
    test_set = os.path.join(d, "test.pkl")
    save_dataset(test_set, sparse_edges(graphs))   # the on-disk form: the C++ packer
    pos = np.asarray(jax.random.normal(jax.random.key(3), jb.pos.shape)) * 1.5
    pos = (pos * np.asarray(jb.node_mask)[..., None]).astype(np.float32)

    # the train step: shards of 5 + 12 and 7 + 6 atoms
    from tsdiff_tpu.core.graph import from_numpy_graphs as jax_from_numpy_graphs

    train_graphs = make_graphs(np.random.default_rng(21), (5, 12, 7, 6))
    tjb = jax_from_numpy_graphs(train_graphs, max_nodes=12)
    tparams = jmodel.init(jax.random.key(5), tjb.atom_type, tjb.r_feat, tjb.p_feat, tjb.pos,
                          tjb.bond_mat, tjb.node_mask)
    t, noise = jax_draws(jax.random.key(11), tjb)
    opt = dict(type="adam", lr=LR, beta1=0.95, beta2=0.999, weight_decay=0.0)
    state = params_from_jax(jax.device_get(tparams))
    train = {
        "dense": dict(cfg={**MODEL_CFG.to_dict(), "use_pallas": True}, state=state, opt=opt,
                      graphs=train_graphs, t=t, noise=noise),
        "packed": dict(cfg={**MODEL_CFG.to_dict(), "packed_train": True}, state=state,
                       opt=opt, graphs=train_graphs, t=t, noise=noise),
    }
    os.makedirs(os.path.join(d, "b3"))
    inp = dict(ckpts=ckpts, test_set=test_set, graphs=graphs, pos=pos, train=train,
               train_cfg=tiny_config(d), train_cfg_b3=tiny_config(os.path.join(d, "b3"),
                                                                   batch_size=3))
    with open(os.path.join(d, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    return dict(inp, jmodel=jmodel, params=params, tparams=tparams, tjb=tjb)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh"))
    inp = write_inputs(d)
    port = free_port()
    env = dict(os.environ, TSDIFF_DIST_TIMEOUT_S=str(COLLECTIVE_TIMEOUT_S),
               LOCAL_WORLD_SIZE="1", PYTHONPATH=os.pathsep.join([REPO, TESTS]))
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(port), d], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANKS_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"the ranks did not finish in {RANKS_TIMEOUT_S} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-6000:]}"
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return dict(inp, dir=d, ranks=ranks)


def load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("kind", ["packed", "dense"])
def test_member_split_matches_jax_unsharded(world, kind):
    import jax.numpy as jnp

    from tsdiff_tpu.core.graph import from_numpy_graphs as jax_from_numpy_graphs
    from tsdiff_tpu.diffusion.ensemble import make_ensemble_score_fn, stack_params

    jb = jax_from_numpy_graphs(world["graphs"], max_nodes=12)
    jmodel = world["jmodel"].clone(fused_score=True) if kind == "packed" else world["jmodel"]
    ref = make_ensemble_score_fn(jmodel, stack_params(world["params"]), jb)(
        jnp.asarray(world["pos"]))
    ref = np.asarray(ref if kind == "packed" else ref[0])
    for rank in world["ranks"]:
        got = rank[f"score_{kind}"]
        assert (got["members"], got["n_members"]) == (2, 4)
        np.testing.assert_allclose(got["score"], ref, rtol=SCORE_RTOL, atol=SCORE_ATOL)


@pytest.mark.parametrize("objective", ["dense", "packed"])
def test_data_parallel_train_step_matches_jax(world, objective):
    import jax

    from tsdiff_tpu.config import Config as JConfig
    from tsdiff_tpu.diffusion.schedules import DiffusionSchedule as JSchedule
    from tsdiff_tpu.train import init_train_state as jax_init_state
    from tsdiff_tpu.train import make_optimizer as jax_make_optimizer
    from tsdiff_tpu.train import make_train_step as jax_make_train_step
    from tsdiff_tpu.train.trainer import get_objective

    from tsdiff_tpu_torch.convert import params_from_jax

    from test_condensenc import MODEL_CFG

    case = world["train"][objective]
    jmodel = world["jmodel"].clone(packed_train=objective == "packed")
    schedule = JSchedule.from_config(MODEL_CFG)
    jtx = jax_make_optimizer(JConfig(case["opt"]), 3000.0)
    key = jax.random.key(11)
    jstate, jm = jax_make_train_step(jmodel, jtx, schedule)(
        jax_init_state(jmodel, jtx, world["tparams"]), world["tjb"], key, LR)
    grads = jax.grad(lambda p: get_objective(jmodel, schedule)(p, world["tjb"], key)[0])(
        world["tparams"])
    want_grads = params_from_jax(jax.device_get(grads))
    want_params = params_from_jax(jax.device_get(jstate.params))
    sides = [rank[f"train_{objective}"] for rank in world["ranks"]]
    # unequal shards: a mean per rank averaged over the ranks is not the loss
    assert [s["local_nodes"] for s in sides] == [17, 13]
    for got in sides:
        np.testing.assert_allclose(got["metrics"]["loss"], float(jm["loss"]), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got["metrics"]["grad_norm"], float(jm["grad_norm"]),
                                   rtol=RTOL, atol=ATOL)
        assert got["metrics"]["n_nodes"] == 30
        assert set(got["grads"]) == set(want_grads) == set(got["params"])
        for k in want_grads:
            np.testing.assert_allclose(got["grads"][k], want_grads[k].numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=k)
            np.testing.assert_allclose(got["params"][k], want_params[k].numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=k)


@pytest.mark.parametrize("flag", ["1,2", "2,1"])
def test_sampling_cli_on_the_mesh_equals_one_rank(world, flag, tmp_path):
    from tsdiff_tpu_torch.cli import sampling

    one = load(sampling.main(world["ckpts"] + ["--test_set", world["test_set"], "--save_dir",
                                                str(tmp_path), *SAMPLE_FLAGS]))
    path = world["ranks"][0][f"sample_{flag}"]
    assert path.endswith(os.path.join("rank0", "samples_all.pkl"))
    mesh = load(path)
    assert [r["smiles"] for r in mesh] == [r["smiles"] for r in one]
    for a, b in zip(mesh, one):
        assert a["sampling_attempts"] == b["sampling_attempts"] == 1
        np.testing.assert_allclose(a["pos_gen"], b["pos_gen"], rtol=SCORE_RTOL, atol=SCORE_ATOL)
    # only rank 0 writes
    rank1 = os.path.dirname(world["ranks"][1][f"sample_{flag}"])
    assert not glob.glob(os.path.join(rank1, "*.pkl"))


def logged_losses(run: str) -> tuple[list[str], list[float]]:
    with open(os.path.join(run, "log.txt")) as f:
        text = f.read()
    train = re.findall(r"\[Train\] Iter (\d+) \| Loss ([\d.]+)", text)
    val = [float(v) for v in re.findall(r"\[Validate\] Iter \d+ \| Loss ([\d.]+)", text)]
    return train, val


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_cli_multihost_logs_the_one_rank_losses(world, case, tmp_path):
    from tsdiff_tpu_torch.cli import train as train_cli

    flags = [f for f in TRAIN_CASES[case] if case != "hybrid"]
    one = train_cli.main([world["train_cfg"], "--logdir", str(tmp_path), "--device", "cpu",
                          *flags])
    runs = [rank[f"train_cli_{case}"] for rank in world["ranks"]]
    assert runs[1].endswith("_proc1") and not runs[0].endswith("_proc1")
    assert glob.glob(os.path.join(runs[0], "checkpoints", "*.ckpt"))
    assert not glob.glob(os.path.join(runs[1], "checkpoints", "*"))
    want_train, want_val = logged_losses(one)
    assert len(want_train) == 3 and len(want_val) == 2
    for run in runs:
        train, val = logged_losses(run)
        assert train == want_train
        np.testing.assert_allclose(val, want_val, rtol=1e-4)
    with open(os.path.join(runs[0], "log.txt")) as f:
        log = f.read()
    shape = "{'dp_dcn': 2, 'dp': 1, 'ens': 1}" if case == "hybrid" else "{'dp': 2, 'ens': 1}"
    assert f"mesh {shape} over gloo" in log
    assert ("device-resident corpus" in log) == (case != "streamed")


@pytest.mark.parametrize("shape", SERVE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_served_round_on_the_mesh_equals_one_rank(world, shape):
    from tsdiff_tpu_torch.serve import SamplerService

    svc = SamplerService(world["ckpts"], n_steps=6, dtype="float32", max_batch=4,
                         fused_score=True, device="cpu", capture=False)
    try:
        want = [r["pos_gen"] for r in svc.generate(world["graphs"][:3])]
    finally:
        svc.close()
    got = world["ranks"][0][f"serve_{shape}"]
    assert len(got) == 3
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=SCORE_RTOL, atol=SCORE_ATOL)


def test_mesh_coordinates_groups_and_replicate_output(world):
    """The ranks' coordinates and data index on each mesh, the hybrid mesh's
    flattened data group, ``replicate_output``, ``replicate`` (rank 0's
    values everywhere), ``global_key`` (the same draws on every rank),
    ``make_global_batch`` (each rank's rows) and ``make_replicated``."""
    for rank, out in enumerate(world["ranks"]):
        dp_major, ens_major = out["mesh_(2, 1)"], out["mesh_(1, 2)"]
        assert dp_major["coords"] == {"dp": rank, "ens": 0} and dp_major["dp_index"] == rank
        assert ens_major["coords"] == {"dp": 0, "ens": rank} and ens_major["dp_index"] == 0
        assert dp_major["backend"] == "gloo"
        # dp (2, 1): each rank's 3 rows, in rank order; ens (1, 2): rank 0's
        np.testing.assert_array_equal(dp_major["full"], np.repeat([[1.0], [2.0]], 3, 0) *
                                      np.ones((6, 2)))
        np.testing.assert_array_equal(ens_major["full"], np.ones((3, 2)))
        helpers = out["helpers"]
        assert helpers["replicated"] == [0.0, 0.0] and helpers["whole"] == [0, 1, 2]
        assert helpers["rows"] == ([[0, 1], [2, 3]] if rank == 0 else [[4, 5], [6, 7]])
        assert helpers["draw"] == world["ranks"][0]["helpers"]["draw"]
        hybrid = out["mesh_hybrid"]
        assert hybrid["shape"] == {"dp_dcn": 2, "dp": 1, "ens": 1} and hybrid["dp"] == 2
        assert hybrid["coords"] == {"dp_dcn": rank, "dp": 0, "ens": 0}
        assert hybrid["dp_index"] == rank and hybrid["data_sum"] == 3.0


def test_cli_mesh_checks_in_a_world_of_two(world):
    for out in world["ranks"]:
        checks = out["checks"]
        assert checks["sampling_mesh_short"] == (
            "SystemExit: --multihost sampling requires the mesh to span all 2 global devices "
            "(got dp=1 x ens=1)")
        assert checks["sampling_ens_indivisible"] == (
            "SystemExit: --mesh 1,2: 3 checkpoints not divisible by ens=2")
        assert checks["train_batch_indivisible"] == (
            "SystemExit: --multihost requires batch_size (3) divisible by the 2 global devices")
        assert checks["serve_without_mesh"].startswith(
            "ValueError: multi-process serving requires a mesh spanning all ranks")


def test_cli_mesh_checks_in_one_process(world, tmp_path):
    """The cluster flags' checks of ``initialize`` (the JAX package's
    three-flag rule), a mesh bigger than the one process, and ``--mesh
    auto`` on one process, which is the unsharded run."""
    from tsdiff_tpu_torch.cli import sampling
    from tsdiff_tpu_torch.parallel import multihost

    base = world["ckpts"] + ["--test_set", world["test_set"], "--save_dir", str(tmp_path),
                             *SAMPLE_FLAGS]
    with pytest.raises(SystemExit, match=r"--mesh 2,1 needs 2 ranks"):
        sampling.main(base + ["--mesh", "2,1"])
    with pytest.raises(ValueError, match="without --coordinator; explicit cluster flags"):
        sampling.main(base + ["--multihost", "--nprocs", "2", "--procid", "0"])
    with pytest.raises(ValueError, match="without --nprocs/--procid"):
        sampling.main(base + ["--multihost", "--coordinator", "127.0.0.1:1"])
    with pytest.raises(ValueError, match="environment torchrun sets"):
        sampling.main(base + ["--multihost"])
    with pytest.raises(ValueError, match="nccl backend needs CUDA"):
        multihost.initialize("127.0.0.1:1", 2, 0, device="cpu", backend="nccl")
    assert not torch.distributed.is_initialized()
    assert multihost.process_count() == 1 and multihost.is_coordinator()
    assert len(load(sampling.main(base + ["--mesh", "auto"]))) == len(world["graphs"])


def test_capture_follows_the_backend():
    """CUDA graphs capture NCCL's collectives but not Gloo's: a Gloo mesh
    walks and steps eagerly, by its backend, never after a failed capture."""
    from types import SimpleNamespace

    from tsdiff_tpu_torch.diffusion.captured import WalkRunner, can_capture
    from tsdiff_tpu_torch.diffusion.sampler import SamplingSettings
    from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
    from tsdiff_tpu_torch.config import Config

    sys.path.insert(0, TESTS)
    from test_condensenc import MODEL_CFG

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    gloo, nccl = SimpleNamespace(backend="gloo"), SimpleNamespace(backend="nccl")
    assert can_capture(cuda) and can_capture(cuda, nccl)
    assert not can_capture(cuda, gloo) and not can_capture(cpu) and not can_capture(cpu, nccl)
    schedule = DiffusionSchedule.from_config(Config(MODEL_CFG.to_dict()))
    with pytest.raises(ValueError, match="Gloo collectives cannot be captured"):
        WalkRunner(None, schedule, SamplingSettings(n_steps=4), capture=True, mesh=gloo)


def test_spec_blocks_and_take():
    from tsdiff_tpu_torch.core.graph import from_numpy_graphs
    from tsdiff_tpu_torch.data.synthetic import make_corpus
    from tsdiff_tpu_torch.parallel.sharding import Spec, take

    spec = Spec(blocks=4, block=2)
    assert spec.slice(8) == slice(4, 6) and Spec().slice(5) == slice(0, 5)
    with pytest.raises(ValueError, match="does not split into 4"):
        spec.slice(6)
    graphs = make_corpus(8, seed=3)
    assert take(graphs, spec) == graphs[4:6]
    batch = from_numpy_graphs(graphs, max_nodes=24)
    rows = take(batch, spec)
    want = from_numpy_graphs(graphs[4:6], max_nodes=24)
    for name in ("atom_type", "r_feat", "pos", "bond_mat", "node_mask"):
        assert torch.equal(getattr(rows, name), getattr(want, name))
    assert take({"w": np.arange(8)}, spec)["w"].tolist() == [4, 5]


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
