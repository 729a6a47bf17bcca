"""The port's steps restructured for CUDA graphs, on the CPU, against the JAX
package's jitted steps (``tsdiff_tpu/train/trainer.py:121-205``,
``tsdiff_tpu/cli/train.py:459-490``, ``tsdiff_tpu/cli/sampling.py:270-345``):

(a) the train step with its state on the device (a 0-dim int32 count and
    step counter, the learning rate a 0-dim float32 tensor refreshed in
    place between steps, Adam's moments updated in place, the EMA's decay
    computed from the device counter) equals JAX's ``make_train_step`` over
    several steps on the same injected timesteps and noise, for the dense
    and the ``packed_train`` objective, at rtol 5e-4, atol 5e-5, as
    ``test_torch_train.py`` holds it; every tensor of the state keeps its
    address;
(b) ``gather_batch`` at a device cursor, past a wrap, equals JAX's at the
    same cursor and plan;
(c) the train CLI's resident loop (``ResidentLoop``: device cursors, one
    plan buffer per bucket) visits the buckets, cursors and plans of the
    JAX CLI's loop over two epochs of a two-bucket schedule, each package
    given the same plan per (bucket, epoch);
(d) the sampling CLI on ``WalkRunner(capture=False)`` writes the samples of
    its eager loop before it moved onto the runner (``dynamic_sampling`` on
    the batch's score function, here ``EagerLoop``) bit for bit, with
    ``--save_traj``, ``--noise_from_time_t`` (from a TS guess), the dense
    ensemble, ``--quant int8`` and a forced clip-20 retry.

The card's half (captured against eager, bucket alternation, a learning
rate changed between replays) is in ``tests/test_torch_cuda.py``."""

import json
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tsdiff_tpu.config import Config as JConfig
from tsdiff_tpu.core.graph import from_numpy_graphs as jax_from_numpy_graphs
from tsdiff_tpu.data.resident import DeviceResidentData as JaxResident
from tsdiff_tpu.data.resident import gather_batch as jax_gather_batch
from tsdiff_tpu.train import init_train_state as jax_init_state
from tsdiff_tpu.train import make_optimizer as jax_make_optimizer
from tsdiff_tpu.train import make_train_step as jax_make_train_step

from tsdiff_tpu_torch.cli import sampling
from tsdiff_tpu_torch.cli import train as train_cli
from tsdiff_tpu_torch.config import Config
from tsdiff_tpu_torch.convert import params_from_jax
from tsdiff_tpu_torch.core.graph import from_numpy_graphs
from tsdiff_tpu_torch.data.resident import FIELDS, DeviceResidentData, gather_batch
from tsdiff_tpu_torch.data.synthetic import make_corpus
from tsdiff_tpu_torch.diffusion import captured as walk_captured
from tsdiff_tpu_torch.diffusion import sampler as torch_sampler
from tsdiff_tpu_torch.diffusion.sampler import dynamic_sampling, final_frame_scale
from tsdiff_tpu_torch.train import init_train_state, make_optimizer, make_train_step
from tsdiff_tpu_torch.train.trainer import make_resident_train_step

from test_condensenc import MODEL_CFG
from test_torch_cli import inputs, load, run  # noqa: F401  (inputs is a fixture)
from test_torch_common import close, make_graphs, small_setup
from test_torch_dense_model import port_model as dense_port_model
from test_torch_packed_train import empty_graph
from test_torch_packed_train import port_model as packed_port_model
from test_torch_train import SCHEDULE_J, SCHEDULE_T, jax_draws

# the learning rate of each step: the device tensor is refreshed between steps
LRS = (5e-4, 5e-4, 2e-4, 1e-3)


def setup_objective(objective: str):
    """``(JAX model, params, JAX batch, port model, port batch)``."""
    if objective == "dense":
        jmodel, (params,), jb, _, tb, _ = small_setup(seed=10)
        return jmodel, params, jb, dense_port_model(params), tb
    rng = np.random.default_rng(21)
    graphs = make_graphs(rng, (5, 8, 12, 7, 10)) + [empty_graph()]
    jb = jax_from_numpy_graphs(graphs, max_nodes=12)
    tb = from_numpy_graphs(graphs, max_nodes=12)
    jmodel, _, _, _, _, _ = small_setup(seed=10)
    params = jmodel.init(jax.random.key(5), jb.atom_type, jb.r_feat, jb.p_feat, jb.pos,
                         jb.bond_mat, jb.node_mask)
    return jmodel.clone(packed_train=True), params, jb, packed_port_model(params), tb


@pytest.mark.parametrize("objective", ["dense", "packed_train"])
def test_device_state_train_steps_match_jax(objective):
    opt = dict(type="adam", lr=LRS[0], beta1=0.95, beta2=0.999, weight_decay=0.0)
    max_norm, ema_decay = 3000.0, 0.999
    jmodel, params, jb, tmodel, tb = setup_objective(objective)
    jtx = jax_make_optimizer(JConfig(opt), max_norm)
    jstate = jax_init_state(jmodel, jtx, params, ema_decay=ema_decay)
    jstep = jax_make_train_step(jmodel, jtx, SCHEDULE_J, ema_decay=ema_decay)

    ttx = make_optimizer(Config(opt), max_norm)
    tstate = init_train_state(tmodel, ttx, ema_decay=ema_decay)
    tstep = make_train_step(tmodel, ttx, SCHEDULE_T, ema_decay=ema_decay)
    lr = torch.tensor(LRS[0], dtype=torch.float32)

    def addresses(state):
        return [t.data_ptr() for t in (*state.params.values(), *state.opt_state["mu"].values(),
                                       *state.opt_state["nu"].values(),
                                       *state.ema_params.values(), lr)]

    before = addresses(tstate)
    key = jax.random.key(3)
    for i, step_lr in enumerate(LRS):
        lr.fill_(step_lr)
        key, k = jax.random.split(key)
        jstate, jm = jstep(jstate, jb, k, step_lr)
        t, noise = jax_draws(k, jb)
        tstate, tm = tstep(tstate, tb, lr, t=t, noise=noise)
        close(tm["grad_norm"], jm["grad_norm"])
        close(tm["loss"], jm["loss"])
        if i == 0:
            counters = (tstate.step, tstate.opt_state["count"])
            assert all(c.dtype == torch.int32 and c.dim() == 0 for c in counters)
        # the same tensors, advanced in place
        assert tstate.step is counters[0] and tstate.opt_state["count"] is counters[1]
        assert addresses(tstate) == before
        adam = jstate.opt_state[1]
        for tree, got in ((jstate.params, tstate.params), (jstate.ema_params, tstate.ema_params),
                          (adam.mu, tstate.opt_state["mu"]), (adam.nu, tstate.opt_state["nu"])):
            want = params_from_jax(jax.device_get(tree))
            assert set(want) == set(got)
            for name, v in got.items():
                close(v, want[name])
        assert int(tstate.step) == int(jstate.step) == i + 1
        assert int(tstate.opt_state["count"]) == int(adam.count) == i + 1


BATCH = 4
BUCKETS = [8, 16, 24]


def test_gather_batch_at_a_device_cursor_matches_jax():
    graphs = make_corpus(23, seed=5)
    mine = DeviceResidentData(graphs, BATCH, BUCKETS, seed=3)
    ref = JaxResident(graphs, BATCH, bucket_sizes=BUCKETS, seed=3)
    for b in ref.buckets:
        jplan = ref.make_plan(b, 1)
        plan = torch.from_numpy(np.array(jplan))
        n = ref.n_batches[b]
        for c in (0, n - 1, n, 2 * n + 1):   # past one wrap and two
            cursor = torch.tensor(c)
            got = gather_batch(mine.buckets[b], plan, cursor, BATCH)
            want = jax_gather_batch(ref.buckets[b], jplan, jnp.int32(c), BATCH)
            for k in FIELDS:
                np.testing.assert_array_equal(getattr(got, k).numpy(),
                                              np.asarray(getattr(want, k)), err_msg=k)
            assert int(cursor) == c


def fixed_plans(n_graphs: dict):
    """One plan per (bucket, epoch) for both packages: a numpy permutation
    seeded by (epoch, bucket), padded with the empty row."""

    def plan(bucket: int, epoch: int, n_batches: int) -> np.ndarray:
        M = n_graphs[bucket]
        order = np.random.default_rng((epoch, bucket)).permutation(M)
        return np.concatenate([order, np.full(n_batches * BATCH - M, M)]).astype(np.int32)

    return plan


def test_resident_loop_matches_jax_over_two_epochs(tmp_path, monkeypatch):
    """The JAX CLI's loop, its steps replaced by a recorder, against the
    port's ``ResidentLoop`` driving ``make_resident_train_step``: per
    iteration the bucket, the cursor and the plan it reads."""
    import tsdiff_tpu.train as jax_train
    from tsdiff_tpu.cli import train as jax_train_cli
    from tsdiff_tpu.data import save_dataset as jax_save_dataset

    corpus = make_corpus(19, seed=8)
    cfg_path = str(tmp_path / "cfg.json")
    jax_save_dataset(str(tmp_path / "train.pkl"), corpus[:14])
    jax_save_dataset(str(tmp_path / "val.pkl"), corpus[14:])
    mine = DeviceResidentData(corpus[:14], BATCH, [16, 24], seed=0)
    schedule = mine.epoch_schedule()
    assert len(set(schedule)) == 2 and len(schedule) >= 3
    iters = 2 * len(schedule) + 2
    model = {**MODEL_CFG.to_dict(), "feat_dim": corpus[0]["r_feat"].shape[-1],
             "num_diffusion_timesteps": 30, "hidden_dim": 16}
    # JSON writes 1e-07 without a dot, which the JAX CLI's YAML reader keeps a string
    model["beta_start"] = 1e-4
    model["encoder"] = {**model["encoder"], "hidden_dim": 16}
    cfg = {"model": model,
           "train": {"seed": 0, "batch_size": BATCH, "val_freq": 1000, "log_freq": 1000,
                     "max_iters": iters, "max_grad_norm": 100.0,
                     "optimizer": {"type": "adam", "lr": 1e-3, "weight_decay": 0.0,
                                   "beta1": 0.95, "beta2": 0.999},
                     "scheduler": {"type": "plateau", "factor": 0.8, "patience": 10,
                                   "min_lr": 1e-4}},
           "dataset": {"train": str(tmp_path / "train.pkl"), "val": str(tmp_path / "val.pkl")},
           "tpu": {"bucket_sizes": [16, 24]}}
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    plan_of = fixed_plans(mine.n_graphs)

    seen_jax = []

    def jax_resident_step(train_step, batch_size, batch_sharding=None):
        def step(state, arrays, plan, cursor, key, lr):
            seen_jax.append((arrays["atom_type"].shape[1], int(cursor), np.array(plan)))
            zero = jnp.zeros((), jnp.float32)
            return state, {"loss_sum": zero, "n_nodes": zero + 1, "grad_norm": zero}, cursor + 1
        return step

    def jax_resident_eval(eval_step, batch_size, batch_sharding=None):
        return lambda params, arrays, plan, cursor, key: (0.0, 1.0)

    monkeypatch.setattr(jax_train, "make_resident_train_step", jax_resident_step)
    monkeypatch.setattr(jax_train, "make_resident_eval_step", jax_resident_eval)
    monkeypatch.setattr(JaxResident, "make_plan", lambda self, b, epoch: jnp.asarray(
        plan_of(b, epoch, self.n_batches[b])))
    jax_train_cli.main([cfg_path, "--logdir", str(tmp_path / "jax_logs"), "--device_data", "on"])
    assert len(seen_jax) == iters

    monkeypatch.setattr(DeviceResidentData, "make_plan", lambda self, b, epoch: torch.from_numpy(
        plan_of(b, epoch, self.n_batches[b]).astype(np.int64)))
    loop = train_cli.ResidentLoop(mine, 1)
    buffers = {b: (p.data_ptr(), loop.cursors[b].data_ptr()) for b, p in loop.plans.items()}
    gathered = []

    def recorder(state, batch, lr, **kw):
        gathered.append(batch)
        return state, {}

    step = make_resident_train_step(recorder, BATCH)
    seen = []
    for _ in range(iters):
        b, arrays, plan, cursor, real = loop.next()
        seen.append((b, int(cursor), plan.numpy().copy()))
        step(None, arrays, plan, cursor, 1e-3)
    assert {b: (p.data_ptr(), loop.cursors[b].data_ptr()) for b, p in loop.plans.items()} \
        == buffers
    for it, ((b, c, plan), (jb_, jc, jplan)) in enumerate(zip(seen, seen_jax)):
        assert (b, c) == (jb_, jc), it
        np.testing.assert_array_equal(plan, jplan, err_msg=str(it))
        want = gather_batch(mine.buckets[b], torch.from_numpy(jplan.astype(np.int64)), c, BATCH)
        assert torch.equal(gathered[it].pos, want.pos), it


class EagerLoop:
    """The sampling CLI's walk before it moved onto ``WalkRunner``:
    ``dynamic_sampling`` on the batch's score function, its start and step
    noise drawn from the batch's generator."""

    def __init__(self, ensemble, schedule, settings, capture, pool=None, step_draws=False,
                 mesh=None):
        self.ensemble, self.schedule, self.settings = ensemble, schedule, settings
        self.captures = 0
        self.nan_rounds = 0     # the runner's counter, which the CLI logs
        self._traj = None

    def run(self, batch, pos_init, gen):
        score_fn = self.ensemble.step_fn(self.ensemble.prepare(batch))
        res = dynamic_sampling(score_fn, self.schedule, pos_init, batch.node_mask,
                               self.settings, generator=gen)
        self._traj = res.traj
        pos = res.pos.cpu().numpy() * final_frame_scale(self.schedule, self.settings)
        nan = bool(res.nan_detected.item())
        self.nan_rounds += nan
        return pos, nan

    def trajectory(self, tier):
        return self._traj


SAMPLING_CASES = {
    "noise": ([], True),
    "save_traj": (["--save_traj"], True),
    "ts_guess_renoised": (["--from_ts_guess", "--denoise_from_time_t", "20",
                           "--noise_from_time_t", "12"], True),
    "dense": ([], False),
    "int8": (["--quant", "int8"], True),
    "retry": ([], True),
}


@pytest.mark.parametrize("case", list(SAMPLING_CASES))
def test_sampling_cli_on_the_runner_equals_the_eager_loop(case, inputs, tmp_path,  # noqa: F811
                                                          monkeypatch):
    extra, fused = SAMPLING_CASES[case]
    if case == "retry":
        # a NaN at the first attempt's clip, none at the retry's clip 20
        clip_norm = torch_sampler.clip_norm
        monkeypatch.setattr(torch_sampler, "clip_norm", lambda v, limit: clip_norm(v, limit)
                            * (float("nan") if limit > 20 else 1.0))
    got = load(run(inputs, tmp_path / "runner", *extra, fused=fused))
    monkeypatch.setattr(walk_captured, "WalkRunner", EagerLoop)
    want = load(run(inputs, tmp_path / "eager", *extra, fused=fused))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["smiles"] == w["smiles"]
        assert g["pos_gen"].dtype == w["pos_gen"].dtype
        np.testing.assert_array_equal(g["pos_gen"], w["pos_gen"])
        assert g["sampling_attempts"] == w["sampling_attempts"] == (2 if case == "retry" else 1)
        assert np.isfinite(g["pos_gen"]).all()
        if case == "save_traj":
            assert g["pos_gen"].shape == (6, len(g["atom_type"]), 3)
    # both walks count the rounds whose NaN flag was set: each batch's first
    # attempt in the retry case, none otherwise
    counted = []
    for side in ("runner", "eager"):
        with open(tmp_path / side / "log.txt") as f:
            counted += [int(n) for n in re.findall(r"Walk rounds flagged NaN: (\d+)$", f.read(),
                                                  re.M)]
    assert len(counted) == 2 and counted[0] == counted[1]
    assert counted[0] > 0 if case == "retry" else counted[0] == 0
