"""Training CLI of the port.

Usage:
    python -m tsdiff_tpu_torch.cli.train config.json [--logdir ./logs --dtype bfloat16 ...]
    python -m tsdiff_tpu_torch.cli.train <previous_log_dir>          # resume

A config (JSON, or YAML where PyYAML is installed) or a log directory to
resume from; seeded set-up; an endless stream of padded batches; the
denoising loss and the optax-equivalent update; validation every
``val_freq`` iterations driving the LR scheduler; a training log line every
``log_freq``; ``<iteration>.ckpt`` written whenever the validation loss
improves; at the end, graphs/s over every iteration after the first
(validation and checkpoints included).  Runs on CUDA unless ``--device cpu`` is given.  With
``model.use_pallas`` the SchNet stack runs through the fused CUDA kernels.

Not ported yet: ``--packed_train``, ``--device_data``, ``--multihost``,
``--mesh_layout``, ``--ckpt_backend orbax``, ``--profile``, ``--pretrain``
and ``dataset.type: sidechain``.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import time

_NOT_PORTED = {
    "packed_train": "--packed_train",
    "device_data": "--device_data",
    "multihost": "--multihost",
    "mesh_layout": "--mesh_layout",
    "ckpt_backend": "--ckpt_backend",
    "profile": "--profile",
    "pretrain": "--pretrain",
}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("config", type=str, help="config .json/.yml, or a log dir to resume")
    parser.add_argument("--resume_iter", type=int, default=None)
    parser.add_argument("--logdir", type=str, default="./logs")
    parser.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    parser.add_argument("--max_iters", type=int, default=None, help="override config max_iters")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    # flags of the JAX package's CLI that are not ported: they raise
    parser.add_argument("--packed_train", action="store_true")
    parser.add_argument("--device_data", choices=["auto", "on", "off"], default=None)
    parser.add_argument("--multihost", action="store_true")
    parser.add_argument("--mesh_layout", choices=["flat", "hybrid"], default=None)
    parser.add_argument("--ckpt_backend", choices=["pickle", "orbax"], default="pickle")
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--pretrain", type=str, default="")
    args = parser.parse_args(argv)
    for attr, flag in _NOT_PORTED.items():
        value = getattr(args, attr)
        if value and not (attr == "ckpt_backend" and value == "pickle"):
            raise NotImplementedError(f"{flag} is not yet ported")
    return args


def _config_path(log_dir: str) -> str:
    for suffix in ("json", "yml", "yaml"):
        found = sorted(glob.glob(os.path.join(log_dir, f"*.{suffix}")))
        if found:
            return found[0]
    raise FileNotFoundError(f"no config file in {log_dir}")


def main(argv=None) -> str:
    """Train; returns the run's log directory."""
    args = parse_args(argv)

    import torch

    from tsdiff_tpu_torch.config import Config, load_config
    from tsdiff_tpu_torch.convert import params_from_jax
    from tsdiff_tpu_torch.data import PaddedBatchLoader, TSDataset, inf_iterator
    from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
    from tsdiff_tpu_torch.models import get_model
    from tsdiff_tpu_torch.train import (
        TrainState,
        get_checkpoint_path,
        init_train_state,
        load_checkpoint,
        make_eval_step,
        make_optimizer,
        make_train_step,
        opt_state_from_checkpoint,
        save_checkpoint,
    )
    from tsdiff_tpu_torch.train.scheduler import get_scheduler
    from tsdiff_tpu_torch.utils.misc import (
        count_parameters,
        get_logger,
        get_new_log_dir,
        resolve_device,
        seed_all,
    )

    device = resolve_device(args.device)
    resume = os.path.isdir(args.config)
    config_path = _config_path(args.config) if resume else args.config
    config = load_config(config_path)
    if config.get("dataset", Config()).get("type") == "sidechain":
        raise NotImplementedError("dataset.type: sidechain is not yet ported")
    seed_all(config.train.seed)
    if args.max_iters is not None:
        config.train.max_iters = args.max_iters

    config_name = os.path.splitext(os.path.basename(config_path))[0]
    log_dir = get_new_log_dir(args.logdir, prefix=config_name, tag="resume" if resume else "")
    ckpt_dir = os.path.join(log_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    logger = get_logger("train", log_dir)
    logger.info(args)
    logger.info(config)
    shutil.copyfile(config_path, os.path.join(log_dir, os.path.basename(config_path)))

    # data
    bucket_sizes = config.get("tpu", Config()).get("bucket_sizes", None)
    train_set = TSDataset(config.dataset.train)
    val_set = TSDataset(config.dataset.val)
    if len(val_set) == 0:
        raise SystemExit(f"validation set is empty ({config.dataset.val})")
    batch_size = config.train.batch_size
    train_iter = inf_iterator(PaddedBatchLoader(
        train_set, batch_size, shuffle=True, bucket_sizes=bucket_sizes,
        seed=config.train.seed, with_indices=True, device=device,
    ))
    val_loader = PaddedBatchLoader(val_set, batch_size, shuffle=False,
                                   bucket_sizes=bucket_sizes, device=device)

    # model, optimizer, schedule
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    init_gen = torch.Generator().manual_seed(config.train.seed)
    model = get_model(config.model, dtype=dtype, generator=init_gen).to(device)
    schedule = DiffusionSchedule.from_config(config.model)
    tx = make_optimizer(config.train.optimizer, config.train.max_grad_norm)
    t0, t1 = config.model.get("t0", 0), config.model.get("t1", None)
    ema_decay = config.train.get("ema_decay", None)
    train_step = make_train_step(model, tx, schedule, t0=t0, t1=t1, ema_decay=ema_decay)
    eval_step = make_eval_step(model, schedule, t0=t0, t1=t1)
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
    logger.info(f"Parameters: {count_parameters(model):,} on {device}, {args.dtype}, "
                f"use_pallas={model.use_pallas}")

    def validate(it: int) -> float:
        sum_loss = sum_n = 0.0
        for vi, batch in enumerate(val_loader):
            gen = torch.Generator(device=device).manual_seed(10_000_000 + vi)
            ls, nn = eval_step(batch, generator=gen)
            sum_loss += float(ls)
            sum_n += float(nn)
        avg = sum_loss / max(sum_n, 1.0)
        scheduler.step(avg)
        logger.info("[Validate] Iter %05d | Loss %.6f" % (it, avg))
        return avg

    gen = torch.Generator(device=device).manual_seed(config.train.seed + 1)
    # summed on the device between log lines, so the loop does not wait on the card
    loss_sum = n_sum = grad_norm_sum = 0.0
    window = 0
    best_loss = float("inf")
    # throughput over the iterations after the first (kernel builds and
    # warm-up), validation and checkpoints included; padding graphs not counted
    t_first = None
    graphs = 0
    for it in range(start_iter, config.train.max_iters + 1):
        batch, indices = next(train_iter)
        state, metrics = train_step(state, batch, scheduler.lr, generator=gen)
        if t_first is None:
            float(metrics["loss_sum"])  # wait for the first step
            t_first = time.monotonic()
        else:
            graphs += int((indices >= 0).sum())
        loss_sum = loss_sum + metrics["loss_sum"]
        n_sum = n_sum + metrics["n_nodes"]
        grad_norm_sum = grad_norm_sum + metrics["grad_norm"]
        window += 1
        last = it == config.train.max_iters
        if it % config.train.log_freq == 0 or last:
            logger.info("[Train] Iter %05d | Loss %.2f | Grad %.2f | LR %.6f" % (
                it, float(loss_sum) / max(float(n_sum), 1.0), float(grad_norm_sum) / window,
                scheduler.lr))
            loss_sum = n_sum = grad_norm_sum = 0.0
            window = 0
        if it % config.train.val_freq == 0 or last:
            avg_val_loss = validate(it)
            if avg_val_loss < best_loss:
                best_loss = avg_val_loss
                save_checkpoint(os.path.join(ckpt_dir, f"{it}.ckpt"), config, state,
                                scheduler.state_dict(), iteration=it, avg_val_loss=avg_val_loss)
                logger.info(f"Saved checkpoint at iter {it} (val {avg_val_loss:.6f})")
    if graphs:  # the last iteration's log line and validation waited for the card
        seconds = time.monotonic() - t_first
        logger.info("[Train] Throughput | Iters %05d-%05d | %d graphs in %.3f s | %.1f graphs/s" % (
            start_iter + 1, config.train.max_iters, graphs, seconds, graphs / seconds))
    return log_dir


if __name__ == "__main__":
    main()
