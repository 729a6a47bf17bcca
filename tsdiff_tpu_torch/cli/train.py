"""Training CLI of the port.

Usage:
    python -m tsdiff_tpu_torch.cli.train config.json [--logdir ./logs --tag seed0 \
        --dtype bfloat16 --packed_train --device_data auto ...]
    python -m tsdiff_tpu_torch.cli.train <previous_log_dir>          # resume

A config (JSON, or YAML where PyYAML is installed) or a log directory to
resume from; seeded set-up; the denoising loss and the optax-equivalent
update; validation every ``val_freq`` iterations driving the LR scheduler; a
training log line every ``log_freq``; ``<iteration>.ckpt`` written whenever
the validation loss improves; at the end, graphs/s over every iteration after
the first (validation and checkpoints included).  Runs on CUDA unless
``--device cpu`` is given.  With ``model.use_pallas`` the SchNet stack runs
through the fused CUDA kernels; ``--packed_train`` (or ``model.packed_train``
in the config) trains through the offset-packed forward.  A config with
``network: dualenc`` trains the GeoDiff-legacy dual encoder on its DDPM
(``type: diffusion``) or annealed score-matching (``type: dsm``,
``train.anneal_power``) objective, on torch ops, through the same input
pipelines and the same captured steps; the legacy conformer graphs have
zero-width features.

The flags and defaults are the JAX package's CLI's:

* the run directory is ``<logdir>/<config name>_<timestamp>_<tag>``, the tag
  being ``--tag``, else ``--name``, with ``_resume`` appended on a resume;
* ``--device_data`` (default ``auto``) chooses the input pipeline: ``on``
  packs the corpus once and keeps it on the device, batches gathered there
  (``data/resident.py``); ``auto`` does so when the train and validation
  corpora pack to at most 4e9 bytes together and otherwise logs why and
  streams; ``off`` streams padded batches packed on the host by a
  background thread (``data/prefetch.py``);
* ``--debug_nans`` fails at the first non-finite loss or gradient norm,
  naming the iteration, with autograd's anomaly detection on;
* ``--name`` with ``--project`` logs to wandb where it can be imported;
* ``--pretrain CKPT`` warm-starts the parameters and the EMA from any file
  ``load_checkpoint`` reads (a ``.ckpt``, or a reference ``.pt``), keeping
  the fresh optimizer state;
* ``--profile`` times the ``data`` phase (the next batch, streamed or
  gathered on the device) and the ``train_step`` phase up to a read of the
  step's loss, so each step waits for the card, and logs ``Phase timings:``
  at the end.

Data parallelism: one process (rank) per GPU, as the JAX CLI runs one
process over its devices.  ``dp`` is the largest divisor of the batch size
that is at most the number of ranks (``--mesh_layout flat``), or
``dp_dcn x dp`` over nodes and their ranks (``--mesh_layout hybrid
--num_slices S``).  Every rank builds the same global plan of batches and
feeds its rows of each (the resident corpus whole on every rank, gathered
at the rank's offset; the streamed loader packing only the rank's rows);
the gradients and the loss's sums are all-reduced inside the step, so
every rank logs the global loss.  Start the ranks with ``torchrun
--nproc_per_node G -m tsdiff_tpu_torch.cli.train ...`` or pass
``--multihost --coordinator H:P --nprocs n --procid i`` to each; NCCL on
CUDA (its collectives captured in the steps' CUDA graphs), Gloo on the CPU
or with ``--dist_backend gloo`` (the steps then run eagerly).  Only rank 0
writes checkpoints and wandb; every other rank logs to its own run
directory, tagged ``_proc<rank>``.

``dataset.type: sidechain`` trains the dual encoder on protein sidechains,
as the JAX CLI does (``tsdiff_tpu/cli/train.py:156-201``): the corpora
(``preprocessing --pdb_glob``) are loaded once; every epoch draws
``dataset.subgraphs_per_protein`` residue-complete subgraphs of radius
``dataset.cutoff`` per protein, seeded ``train.seed + epoch``; validation
scores one fixed subgraph per protein (the middle backbone atom's ball).
The batches carry ``is_sidechain``, so the dual objectives train in
sidechain mode; they stream from the host (never device-resident) and each
train step replays the captured step of its bucket.

Not ported: ``--ckpt_backend orbax`` (§A.2, blocked).
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import os
import shutil
import time

import torch

#: flags of the JAX package's CLI that the port refuses, with their ROADMAP item
_NOT_PORTED = {
    "ckpt_backend": ("--ckpt_backend orbax", "§A.2, blocked: orbax needs JAX"),
}
#: ``--device_data auto`` keeps the corpus on the device up to this many bytes
DEVICE_DATA_BUDGET = int(4e9)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("config", type=str, help="config .json/.yml, or a log dir to resume")
    parser.add_argument("--resume_iter", type=int, default=None)
    parser.add_argument("--logdir", type=str, default="./logs")
    parser.add_argument("--project", type=str, default="")
    parser.add_argument("--name", type=str, default="")
    parser.add_argument("--tag", type=str, default=None)
    parser.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    parser.add_argument("--max_iters", type=int, default=None, help="override config max_iters")
    parser.add_argument("--packed_train", action="store_true",
                        help="train through the offset-packed forward (mlp edge encoder)")
    parser.add_argument("--debug_nans", action="store_true",
                        help="fail at the first non-finite loss or gradient")
    parser.add_argument("--device_data", choices=["auto", "on", "off"], default="auto",
                        help="keep the corpus on the device (auto: when it packs to <= 4e9 bytes)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--pretrain", type=str, default="",
                        help="warm-start params and EMA from a checkpoint (.ckpt or reference .pt)")
    parser.add_argument("--profile", action="store_true",
                        help="log per-phase timings (data, train_step), the device synced per step")
    parser.add_argument("--multihost", action="store_true", default=False,
                        help="multi-process data parallelism, one rank per GPU; pass "
                             "--coordinator/--nprocs/--procid, or omit all three under torchrun")
    parser.add_argument("--mesh_layout", choices=["flat", "hybrid"], default="flat",
                        help="hybrid: (dp_dcn, dp) data parallelism, the outer axis over nodes")
    parser.add_argument("--num_slices", type=int, default=None,
                        help="hybrid layout: node count (default: world / LOCAL_WORLD_SIZE)")
    parser.add_argument("--coordinator", type=str, default=None, help="host:port of rank 0")
    parser.add_argument("--nprocs", type=int, default=None, help="number of ranks")
    parser.add_argument("--procid", type=int, default=None, help="this process's rank")
    parser.add_argument("--dist_backend", type=str, default=None, choices=["nccl", "gloo"],
                        help="collectives' backend (default: nccl on cuda, gloo on cpu)")
    # a flag of the JAX package's CLI that is not ported: it raises
    parser.add_argument("--ckpt_backend", choices=["pickle", "orbax"], default="pickle")
    args = parser.parse_args(argv)
    for attr, (flag, item) in _NOT_PORTED.items():
        value = getattr(args, attr)
        if value and not (attr == "ckpt_backend" and value == "pickle"):
            raise NotImplementedError(f"{flag} is not yet ported (ROADMAP {item})")
    return args


class ResidentLoop:
    """The resident loop's state, as the JAX CLI keeps it
    (``tsdiff_tpu/cli/train.py:459-490``): the epoch's bucket schedule walked
    in order, one plan per bucket made anew each epoch (copied into the
    bucket's plan buffer, whose address a captured step holds), one device
    cursor per bucket that the step advances and the gather wraps.  Nothing
    but a new epoch's plans crosses from the host to the device."""

    def __init__(self, res, start_iter: int):
        self.res = res
        self.schedule = res.epoch_schedule()
        self.epoch, self.pos = divmod(start_iter - 1, len(self.schedule))
        # the host's mirror of the cursors counts the real graphs of a batch
        self._host = {b: self.schedule[:self.pos].count(b) for b in res.buckets}
        self.plans = {b: res.make_plan(b, self.epoch) for b in res.buckets}
        self.cursors = {b: torch.tensor(self._host[b], device=res.device) for b in res.buckets}

    def next(self) -> tuple:
        """``(bucket, arrays, plan, cursor, real graphs)`` of the next step;
        the step advances ``cursor``.  A new epoch's plans are copied in
        before its first step is queued, behind the last step that reads the
        old ones."""
        if self.pos == len(self.schedule):
            self.epoch, self.pos = self.epoch + 1, 0
            for b, plan in self.plans.items():
                plan.copy_(self.res.make_plan(b, self.epoch))
        b = self.schedule[self.pos]
        self.pos += 1
        real = self.res.real_graphs(b, self._host[b])
        self._host[b] += 1
        return b, self.res.buckets[b], self.plans[b], self.cursors[b], real


def make_train_mesh(args, batch_size: int, nproc: int, device):
    """The data-parallel mesh of the ranks, None for one rank, with the JAX
    CLI's checks (``tsdiff_tpu/cli/train.py:250-272``)."""
    from tsdiff_tpu_torch.parallel import make_hybrid_mesh, make_mesh

    if args.mesh_layout == "hybrid":
        if nproc == 1:
            if args.num_slices not in (None, 1):
                raise ValueError(f"1 ranks not divisible by {args.num_slices} slices")
            return None
        mesh = make_hybrid_mesh(ens=1, num_slices=args.num_slices, device=device)
        if batch_size % mesh.dp != 0:
            raise SystemExit(
                f"--mesh_layout hybrid: batch_size ({batch_size}) "
                f"not divisible by dp_dcn x dp = {mesh.dp}"
            )
        return mesh
    dp = max(d for d in range(1, nproc + 1) if batch_size % d == 0)
    if nproc > 1 and dp != nproc:
        # every rank must hold a block of each batch
        raise SystemExit(
            f"--multihost requires batch_size ({batch_size}) "
            f"divisible by the {nproc} global devices"
        )
    return make_mesh(dp=dp, ens=1, device=device) if nproc > 1 else None


def sidechain_draws(config):
    """``draw(path, seed, fix) -> subgraphs`` of a ``dataset.type:
    sidechain`` config: the corpus at ``path`` loaded once, then
    ``subgraphs_per_protein`` residue-complete subgraphs per protein drawn
    with ``np.random.default_rng(seed)`` (one, the middle backbone atom's,
    with ``fix``), those without a sidechain atom dropped; the JAX CLI's
    draws (``tsdiff_tpu/cli/train.py:167-183``)."""
    from tsdiff_tpu_torch.data.dataset import load_dataset
    from tsdiff_tpu_torch.data.pdb import SidechainConformationDataset

    cutoff = config.dataset.get("cutoff", 10.0)
    n_sub = config.dataset.get("subgraphs_per_protein", 50)
    corpora: dict = {}

    def draw(path: str, seed: int, fix: bool) -> list[dict]:
        if path not in corpora:
            corpora[path] = load_dataset(path)[0]
        ds = SidechainConformationDataset(corpora[path], cutoff=cutoff, fix_subgraph=fix,
                                          seed=seed)
        out = []
        for i in range(len(ds)):
            for _ in range(1 if fix else n_sub):
                s = ds[i]
                if s is not None:
                    out.append(s)
        return out

    return draw


def _config_path(log_dir: str) -> str:
    for suffix in ("json", "yml", "yaml"):
        found = sorted(glob.glob(os.path.join(log_dir, f"*.{suffix}")))
        if found:
            return found[0]
    raise FileNotFoundError(f"no config file in {log_dir}")


def main(argv=None, capture: bool = True) -> str:
    """Train; returns the run's log directory.  On CUDA each step replays a
    CUDA graph of it (``train/captured.py``) unless ``capture`` is False or
    ``--debug_nans`` is given (its checks read the card inside the step);
    on the CPU the steps run eagerly."""
    args = parse_args(argv)
    anomaly = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(args.debug_nans or anomaly)
    try:
        return _train(args, capture)
    finally:
        torch.autograd.set_detect_anomaly(anomaly)


def _train(args, capture: bool) -> str:
    from tsdiff_tpu_torch.config import Config, load_config
    from tsdiff_tpu_torch.convert import params_from_jax
    from tsdiff_tpu_torch.data import PaddedBatchLoader, TSDataset, inf_iterator
    from tsdiff_tpu_torch.data.prefetch import Prefetcher, to_device
    from tsdiff_tpu_torch.data.resident import CorpusTooLarge, DeviceResidentData
    from tsdiff_tpu_torch.diffusion.objective import draw_timesteps_and_noise
    from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
    from tsdiff_tpu_torch.models import get_model
    from tsdiff_tpu_torch.parallel import multihost
    from tsdiff_tpu_torch.train import (
        TrainState,
        get_checkpoint_path,
        get_objective,
        init_train_state,
        load_checkpoint,
        make_eval_step,
        make_optimizer,
        make_resident_eval_step,
        make_resident_train_step,
        make_train_step,
        opt_state_from_checkpoint,
        save_checkpoint,
    )
    from tsdiff_tpu_torch.diffusion.captured import can_capture
    from tsdiff_tpu_torch.train.captured import StepGraphs
    from tsdiff_tpu_torch.train.scheduler import get_scheduler
    from tsdiff_tpu_torch.utils.misc import (
        count_parameters,
        get_logger,
        get_new_log_dir,
        resolve_device,
        seed_all,
    )
    from tsdiff_tpu_torch.utils.profiling import PhaseTimer

    device = resolve_device(args.device)
    if args.multihost or multihost.launched_by_torchrun():
        device = multihost.initialize(args.coordinator, args.nprocs, args.procid,
                                      device=device, backend=args.dist_backend)
    nproc = multihost.process_count()
    is_coord = multihost.is_coordinator()
    resume = os.path.isdir(args.config)
    config_path = _config_path(args.config) if resume else args.config
    config = load_config(config_path)
    seed_all(config.train.seed)
    if args.max_iters is not None:
        config.train.max_iters = args.max_iters

    config_name = os.path.splitext(os.path.basename(config_path))[0]
    tag = args.tag if args.tag is not None else args.name
    if not is_coord:
        # every rank keeps its own log dir; only the coordinator writes
        # checkpoints and wandb
        rank = torch.distributed.get_rank()
        tag = f"{tag}_proc{rank}" if tag else f"proc{rank}"
    log_dir = get_new_log_dir(args.logdir, prefix=config_name,
                              tag=f"{tag}_resume" if resume else tag)
    ckpt_dir = os.path.join(log_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    logger = get_logger("train", log_dir)
    logger.info(args)
    logger.info(config)
    shutil.copyfile(config_path, os.path.join(log_dir, os.path.basename(config_path)))

    wandb = None
    if args.name and args.project and is_coord:
        try:
            import wandb

            wandb.init(project=args.project, name=args.name)
            wandb.config = config.to_dict()
        except ImportError:
            wandb = None
            logger.warning("wandb not installed; logging to file only")

    # data: the corpus resident on the device where --device_data lets it,
    # else padded batches packed on the host by a background thread
    bucket_sizes = config.get("tpu", Config()).get("bucket_sizes", None)
    sidechain_mode = config.dataset.get("type") == "sidechain"
    if sidechain_mode:
        draw_subgraphs = sidechain_draws(config)
        val_set = TSDataset(draw_subgraphs(config.dataset.val, 0, True))
        logger.info(f"sidechain mode: {len(val_set)} fixed val subgraphs; "
                    f"train subgraphs redrawn every epoch")
    else:
        train_set = TSDataset(config.dataset.train)
        val_set = TSDataset(config.dataset.val)
    if len(val_set) == 0:
        raise SystemExit(f"validation set is empty ({config.dataset.val})")
    batch_size = config.train.batch_size
    mesh = make_train_mesh(args, batch_size, nproc, device)
    rows = None
    if mesh is not None:
        from tsdiff_tpu_torch.parallel.sharding import batch_spec

        rows = batch_spec(mesh).slice(batch_size)
    logger.info(f"Ranks: {nproc} -> mesh " + (f"{mesh.shape} over {mesh.backend}"
                                              if mesh is not None else "none"))
    train_res = val_res = None
    if sidechain_mode:
        logger.info("sidechain mode: batches stream through the prefetcher")
    elif args.device_data != "off":
        budget = DEVICE_DATA_BUDGET if args.device_data == "auto" else None
        try:
            train_res = DeviceResidentData(train_set.graphs, batch_size, bucket_sizes,
                                           seed=config.train.seed, device=device, upload=False)
            val_res = DeviceResidentData(val_set.graphs, batch_size, bucket_sizes,
                                         device=device, upload=False)
            total = train_res.nbytes + val_res.nbytes
            if budget is not None and total > budget:
                raise CorpusTooLarge(f"packed corpus is {total / 1e9:.2f} GB "
                                     f"(> {budget / 1e9:.2f} GB budget)")
            train_res.upload()
            val_res.upload()
        except CorpusTooLarge as e:
            logger.info(f"device_data auto: {e}; streaming batches through the prefetcher")
            train_res = val_res = None
        else:
            logger.info(f"device-resident corpus: {total:,} bytes on {device} (batches per "
                        f"bucket: train {train_res.n_batches}, val {val_res.n_batches})")
    if train_res is None:
        def loader(graphs, seed: int):
            return PaddedBatchLoader(TSDataset(graphs), batch_size, shuffle=True,
                                     bucket_sizes=bucket_sizes, seed=seed, with_indices=True,
                                     rows=rows)

        def sidechain_epochs():
            epoch = 0
            while True:
                seed = config.train.seed + epoch
                yield from loader(draw_subgraphs(config.dataset.train, seed, False), seed)
                epoch += 1

        stream = sidechain_epochs() if sidechain_mode else inf_iterator(
            loader(train_set.graphs, config.train.seed))
        train_iter = iter(Prefetcher(stream, depth=2,
                                     transfer=lambda item: (to_device(item[0], device), item[1])))
        val_loader = PaddedBatchLoader(val_set, batch_size, shuffle=False,
                                       bucket_sizes=bucket_sizes, device=device, rows=rows)
    else:
        val_plans = {b: val_res.fixed_plan(b) for b in val_res.buckets}

    # model, optimizer, schedule
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    if args.packed_train:
        config.model.packed_train = True
    init_gen = torch.Generator().manual_seed(config.train.seed)
    model = get_model(config.model, dtype=dtype, generator=init_gen).to(device)
    schedule = DiffusionSchedule.from_config(config.model)
    tx = make_optimizer(config.train.optimizer, config.train.max_grad_norm)
    t0, t1 = config.model.get("t0", 0), config.model.get("t1", None)
    ema_decay = config.train.get("ema_decay", None)
    anneal_power = config.train.get("anneal_power", 2.0)
    train_step = make_train_step(model, tx, schedule, t0=t0, t1=t1, ema_decay=ema_decay,
                                 debug_nans=args.debug_nans, mesh=mesh, anneal_power=anneal_power)
    eval_step = make_eval_step(model, schedule, t0=t0, t1=t1, mesh=mesh,
                               anneal_power=anneal_power)
    res_train_step = make_resident_train_step(train_step, batch_size, mesh)
    res_eval_step = make_resident_eval_step(eval_step, batch_size, mesh)
    scheduler = get_scheduler(config.train.scheduler, config.train.optimizer.lr)
    state = init_train_state(model, tx, ema_decay=ema_decay)
    start_iter = 1

    if resume:
        ckpt_path, start_iter = get_checkpoint_path(
            os.path.join(args.config, "checkpoints"), it=args.resume_iter
        )
        logger.info(f"Resuming from {ckpt_path} (iteration {start_iter})")
        ck = load_checkpoint(ckpt_path)
        model.load_state_dict(params_from_jax(ck["params"]))
        ema = None
        if ema_decay:  # a checkpoint without EMA seeds it from its own weights
            src = ck.get("ema_params") or ck["params"]
            ema = {k: v.to(device) for k, v in params_from_jax(src).items()}
        state = TrainState(dict(model.named_parameters()),
                           opt_state_from_checkpoint(ck, device), start_iter, ema)
        if ck.get("scheduler"):
            scheduler.load_state_dict(ck["scheduler"])
    if args.pretrain:
        logger.info(f"Warm-start weights from {args.pretrain}")
        warm = params_from_jax(load_checkpoint(args.pretrain)["params"])
        model.load_state_dict(warm)
        ema = {k: v.to(device) for k, v in warm.items()} if ema_decay else None
        state = TrainState(dict(model.named_parameters()), state.opt_state, state.step, ema)
    loop = ResidentLoop(train_res, start_iter) if train_res is not None else None
    logger.info(f"Parameters: {count_parameters(model):,} on {device}, {args.dtype}, "
                f"{type(model).__name__}, use_pallas={getattr(model, 'use_pallas', False)}, "
                f"packed_train={getattr(model, 'packed_train', False)}")

    # JAX runs every step as one compiled program: here one CUDA graph per
    # (step kind, bucket), where its checks do not read the card
    graphs = StepGraphs(device) if capture and can_capture(device, mesh) and not args.debug_nans \
        else None
    if graphs is not None:
        logger.info("Steps replay CUDA graphs, one per (step kind, bucket)")
    elif capture and device.type == "cuda" and not can_capture(device, mesh):
        logger.info("Gloo collectives cannot be captured in a CUDA graph: steps run eagerly")
    # the levels of the model family's objective: timesteps or sigma levels
    _, (t_lo, t_hi) = get_objective(model, schedule, t0, t1, anneal_power)
    # the learning rate on the device, refreshed only when the scheduler moves it
    lr_host = scheduler.lr
    lr = torch.tensor(lr_host, dtype=torch.float32, device=device)

    def run(key, fn, *inputs):
        """``fn(*inputs)``, eagerly or from the graph of ``key``."""
        return fn(*inputs) if graphs is None else graphs(key, fn, *inputs)

    def draws(gen, bucket: int):
        return draw_timesteps_and_noise(gen, (batch_size, bucket, 3), t_lo, t_hi, device)

    if val_res is not None:
        val_cursors = {b: torch.zeros((), dtype=torch.int64, device=device)
                       for b in val_res.buckets}

    def val_losses():
        """``(loss_sum, n_nodes)`` of every validation batch, in the JAX
        CLI's order, each batch's draws seeded ``10_000_000 + vi``."""
        vi = 0
        if val_res is None:
            for batch in val_loader:
                gen = torch.Generator(device=device).manual_seed(10_000_000 + vi)
                yield run(("eval", batch.pos.shape[1]),
                          lambda b, t, noise: eval_step(b, t=t, noise=noise),
                          batch, *draws(gen, batch.pos.shape[1]))
                vi += 1
            return
        for b, arrays in val_res.buckets.items():
            cursor = val_cursors[b]
            cursor.zero_()
            for _ in range(val_res.n_batches[b]):
                gen = torch.Generator(device=device).manual_seed(10_000_000 + vi)
                yield run(("eval", b), lambda t, noise, arrays=arrays, b=b, cursor=cursor:
                          res_eval_step(arrays, val_plans[b], cursor, t=t, noise=noise),
                          *draws(gen, b))
                vi += 1

    def validate(it: int) -> float:
        sum_loss = sum_n = 0.0
        for ls, nn in val_losses():
            sum_loss += float(ls)
            sum_n += float(nn)
        avg = sum_loss / max(sum_n, 1.0)
        scheduler.step(avg)
        logger.info("[Validate] Iter %05d | Loss %.6f" % (it, avg))
        if wandb is not None:
            wandb.log({"val/loss": avg}, step=it)
        return avg

    def train_once(gen) -> tuple[dict, int]:
        """One training step: ``(metrics, real graphs)``."""
        if loop is None:
            with phase("data"):
                batch, indices = next(train_iter)
            bucket, real = batch.pos.shape[1], int((indices >= 0).sum())
            with phase("train_step"):
                metrics = run(("train", bucket),
                              lambda b, t, noise: train_step(state, b, lr, t=t, noise=noise)[1],
                              batch, *draws(gen, bucket))
                if timer is not None:
                    float(metrics["loss"])  # --profile: the step waits for the card
            return metrics, real
        with phase("data"):
            bucket, arrays, plan, cursor, real = loop.next()
        with phase("train_step"):
            metrics = run(("train", bucket), lambda t, noise: res_train_step(
                state, arrays, plan, cursor, lr, t=t, noise=noise)[1], *draws(gen, bucket))
            if timer is not None:
                float(metrics["loss"])
        return metrics, real

    gen = torch.Generator(device=device).manual_seed(config.train.seed + 1)
    # summed on the device between log lines, so the loop does not wait on the card
    loss_sum = n_sum = grad_norm_sum = 0.0
    window = 0
    best_loss = float("inf")
    # throughput over the iterations after the first (kernel builds and
    # warm-up), validation and checkpoints included; padding graphs not counted
    t_first = None
    n_graphs = 0
    timer = PhaseTimer() if args.profile else None

    def phase(name: str):
        return timer.phase(name) if timer is not None else contextlib.nullcontext()

    try:
        for it in range(start_iter, config.train.max_iters + 1):
            try:
                metrics, real = train_once(gen)
            except FloatingPointError as e:  # --debug_nans
                raise FloatingPointError(f"iteration {it}: {e}") from e
            if t_first is None:
                float(metrics["loss_sum"])  # wait for the first step
                t_first = time.monotonic()
            else:
                n_graphs += real
            loss_sum = loss_sum + metrics["loss_sum"]
            n_sum = n_sum + metrics["n_nodes"]
            grad_norm_sum = grad_norm_sum + metrics["grad_norm"]
            window += 1
            last = it == config.train.max_iters
            if it % config.train.log_freq == 0 or last:
                train_loss = float(loss_sum) / max(float(n_sum), 1.0)
                grad_norm = float(grad_norm_sum) / window
                logger.info("[Train] Iter %05d | Loss %.2f | Grad %.2f | LR %.6f" % (
                    it, train_loss, grad_norm, scheduler.lr))
                if wandb is not None:
                    wandb.log({"train/loss": train_loss, "train/lr": scheduler.lr,
                               "train/grad_norm": grad_norm}, step=it)
                loss_sum = n_sum = grad_norm_sum = 0.0
                window = 0
            if it % config.train.val_freq == 0 or last:
                avg_val_loss = validate(it)
                if scheduler.lr != lr_host:
                    lr_host = scheduler.lr
                    lr.fill_(lr_host)
                if avg_val_loss < best_loss:
                    best_loss = avg_val_loss
                    if is_coord:  # only the coordinator writes checkpoints
                        save_checkpoint(os.path.join(ckpt_dir, f"{it}.ckpt"), config, state,
                                        scheduler.state_dict(), iteration=it,
                                        avg_val_loss=avg_val_loss)
                        logger.info(f"Saved checkpoint at iter {it} (val {avg_val_loss:.6f})")
    finally:
        if loop is None:
            train_iter.close()  # ends the prefetcher's worker
    if graphs is not None:
        logger.info("[Train] CUDA graphs | recorded %d: %s | replays %s" % (
            len(graphs.recorded), ", ".join(f"{k} {b}" for k, b in graphs.recorded),
            ", ".join(f"{k} {b} {n}" for (k, b), n in sorted(graphs.replays.items()))))
    if n_graphs:  # the last iteration's log line and validation waited for the card
        seconds = time.monotonic() - t_first
        logger.info("[Train] Throughput | Iters %05d-%05d | %d graphs in %.3f s | %.1f graphs/s" % (
            start_iter + 1, config.train.max_iters, n_graphs, seconds, n_graphs / seconds))
    if timer is not None:
        logger.info("Phase timings:\n%s", timer.summary())
    return log_dir


if __name__ == "__main__":
    main()
