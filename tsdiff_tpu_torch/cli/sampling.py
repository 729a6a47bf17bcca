"""Ensemble TS-generation CLI on PyTorch.

Usage:
    python -m tsdiff_tpu_torch.cli.sampling CKPT [CKPT ...] --test_set X.pkl \
        --save_dir OUT [--fused_score [--quant int8] --dtype bfloat16 \
        --sampling_type ld --n_steps 5000 --timestep_respacing 625 \
        --device cuda ...]

Loads N checkpoints (``.ckpt`` pickles, ``.orbax`` directories or reference
``.pt`` files; the model is rebuilt from the embedded config), reads the test set (a ``tsdiff_tpu.v1``
or reference PyG ``.pkl``; a ``.txt`` of reaction SMARTS, one per line, or
one raw SMARTS string, featurized with ``--feat_dict``, which needs RDKit),
batches it with optional per-reaction repetition (each batch padded to a
row tier and a node bucket), runs the ensemble reverse diffusion (the dense
ensemble in torch ops, or with ``--fused_score`` the offset-packed score
kernel, whose pair-row products ``--quant int8`` runs in int8), retries a
batch at clip 20 if NaNs appear, rescales the final frame, and pickles
incremental (``samples_not_all.pkl``) and final (``samples_all.pkl``)
results.  Each result records ``sampling_attempts``, the number of sampling
runs its batch took.

The walk of each (bucket, tier, clip) is one ``WalkRunner``
(``diffusion/captured.py``), as the JAX CLI compiles one program per
(bucket, tier, clip): on CUDA each step replays one CUDA graph of the
sampling step, recorded at the first batch of that shape, every graph from
one memory pool; on the CPU the same step runs eagerly.  The step noise is
drawn before the walk, one draw per step from the batch's generator, so the
samples are those of the eager loop (``dynamic_sampling``).

Runs on CUDA unless ``--device cpu`` is given.  ``TSDIFF_COMPILE_CACHE``
names a directory that keeps the compiled kernels between processes
(``utils/compile_cache.py``).

A dual-encoder ensemble (the GeoDiff-legacy family, ``network: dualenc``)
averages its members' per-atom scores (the local branch plus the clipped,
down-weighted global branch, ``diffusion/dual_objective.py``) and walks a
``DualWalk`` on the same runners: a ``type: diffusion`` model the DDPM walk of
``--sampling_type`` (``--timestep_respacing`` applies), a ``type: dsm`` model
annealed Langevin over its sigma ladder, ``--n_steps`` steps per level, from
unit-variance noise and with no final rescale; ``--sigma_respacing M`` walks
an evenly strided M-level subsequence of the ladder, its ends kept.
``--fused_score`` and ``--quant`` apply to condensed models only.

Several GPUs: one process (rank) per GPU on a ``(dp, ens)`` mesh
(``parallel/``), as the JAX CLI runs one process over a device mesh.  The
members split over ``ens`` (each rank loads its block), the batch rows over
``dp`` (each rank packs its rows; every tier is a multiple of ``dp``); a
batch's start and step noise are drawn for the whole tier on every rank, so
the samples are those of one rank with the same seed up to the order of the
member sum.  ``--mesh auto`` (the default) takes ``ens = gcd(ranks,
checkpoints)``.  Start the ranks with ``torchrun --nproc_per_node G -m
tsdiff_tpu_torch.cli.sampling ...`` or pass ``--multihost --coordinator H:P
--nprocs n --procid i`` to each; NCCL on CUDA (the walk's collective
captured in its CUDA graph), Gloo on the CPU or with ``--dist_backend gloo``
(the walk then runs eagerly).  Only rank 0 logs progress and writes the
pickles.
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle

import numpy as np
import torch


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def batching(items, batch_size, repeat_num=1):
    """Repeat each item repeat_num times, then chunk."""
    expanded = []
    for x in items:
        expanded.extend([dict(x) for _ in range(repeat_num)])
    for i in range(0, len(expanded), batch_size):
        yield expanded[i : i + batch_size]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("ckpt", type=str, nargs="+", help="checkpoint path(s) for the ensemble")
    parser.add_argument("--batch_size", type=int, default=100)
    parser.add_argument("--resume", type=str, default=None, help="path to partial results pickle")
    parser.add_argument("--save_traj", action="store_true", default=False)
    parser.add_argument("--save_dir", type=str, required=True)
    parser.add_argument("--test_set", type=str, required=True,
                        help=".pkl dataset (tsdiff_tpu.v1 or reference PyG), .txt of reaction "
                             "SMARTS, or one raw reaction SMARTS")
    parser.add_argument("--feat_dict", type=str,
                        default="./data/TS/wb97xd3/random_split_42/feat_dict.pkl",
                        help="feature vocabulary for .txt and raw-SMARTS test sets")
    parser.add_argument("--start_idx", type=int, default=0)
    parser.add_argument("--end_idx", type=int, default=9999)
    parser.add_argument("--repeat", type=int, default=1)
    parser.add_argument("--from_ts_guess", action="store_true", default=False)
    parser.add_argument("--denoise_from_time_t", type=int, default=None)
    parser.add_argument("--noise_from_time_t", type=int, default=None)
    parser.add_argument("--clip", type=float, default=1000.0)
    parser.add_argument("--n_steps", type=int, default=5000)
    parser.add_argument("--sampling_type", type=str, default="ld",
                        help="ld | ddpm | ddpm_noisy | ddpm_det | generalized")
    parser.add_argument("--timestep_respacing", type=int, default=None,
                        help="walk an evenly-strided M-step subsequence of the n_steps window")
    parser.add_argument("--sigma_respacing", type=int, default=None,
                        help="dsm models: anneal through an evenly-strided M-level subsequence "
                             "of the sigma ladder (ends kept), --n_steps steps per level")
    parser.add_argument("--eta", type=float, default=1.0)
    parser.add_argument("--step_lr", type=float, default=1e-7)
    parser.add_argument("--seed", type=int, default=2022)
    parser.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    parser.add_argument("--sort_by_size", action="store_true", default=False,
                        help="sort reactions by atom count before batching")
    parser.add_argument("--use_ema", action="store_true", default=False,
                        help="use EMA weights from checkpoints when present")
    parser.add_argument("--fused_score", action="store_true", default=False,
                        help="offset-packed fused score kernel, one launch per step for all "
                             "members (fastest with --dtype bfloat16); without it, the dense "
                             "ensemble in torch ops")
    parser.add_argument("--quant", type=str, default="none", choices=["none", "int8"],
                        help="with --fused_score: int8 pair-row products (per-row dynamic "
                             "activation scales, per-tensor weight scales)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--mesh", type=str, default="auto",
                        help="'DP,ENS' mesh of ranks, '1,1' to disable, or 'auto' (default): "
                             "ENS = gcd(#ranks, #ckpts) with the rest as data parallelism. "
                             "Members split over ENS, the batch over DP")
    parser.add_argument("--multihost", action="store_true", default=False,
                        help="multi-process sampling, one rank per GPU; only rank 0 writes "
                             "results. Pass --coordinator/--nprocs/--procid, or omit all three "
                             "under torchrun")
    parser.add_argument("--coordinator", type=str, default=None, help="host:port of rank 0")
    parser.add_argument("--nprocs", type=int, default=None, help="number of ranks")
    parser.add_argument("--procid", type=int, default=None, help="this process's rank")
    parser.add_argument("--dist_backend", type=str, default=None, choices=["nccl", "gloo"],
                        help="collectives' backend (default: nccl on cuda, gloo on cpu; gloo "
                             "lets two ranks share one card)")
    return parser.parse_args(argv)


def setup_mesh(args, n_ckpts: int, device):
    """``(mesh or None, device)`` of the sampling CLI's mesh flags, with the
    JAX CLI's checks (``tsdiff_tpu/cli/sampling.py:174-212``); joins the
    process group first under ``--multihost`` or ``torchrun``."""
    import math

    from tsdiff_tpu_torch.parallel import multihost

    if args.multihost or multihost.launched_by_torchrun():
        device = multihost.initialize(args.coordinator, args.nprocs, args.procid,
                                      device=device, backend=args.dist_backend)
    n_ranks = multihost.process_count()
    if args.mesh == "auto":
        ens = math.gcd(n_ranks, n_ckpts)
        dp = n_ranks // ens
    else:
        dp, ens = (int(x) for x in args.mesh.split(","))
    if n_ranks > 1 and dp * ens != n_ranks:
        raise SystemExit(
            f"--multihost sampling requires the mesh to span all "
            f"{n_ranks} global devices (got dp={dp} x ens={ens})"
        )
    if dp * ens == 1:
        return None, device
    if n_ranks == 1:
        raise SystemExit(
            f"--mesh {dp},{ens} needs {dp * ens} ranks, one per device; start them under "
            "torchrun, or each with --multihost --coordinator/--nprocs/--procid"
        )
    if n_ckpts % ens:
        raise SystemExit(f"--mesh {dp},{ens}: {n_ckpts} checkpoints not divisible by ens={ens}")
    from tsdiff_tpu_torch.parallel import make_mesh

    return make_mesh(dp=dp, ens=ens, device=device), device


def main(argv=None, capture: bool = True) -> str:
    """Sample; returns the path of ``samples_all.pkl``.  ``capture=False``
    walks eagerly on CUDA too."""
    args = parse_args(argv)

    from tsdiff_tpu_torch.utils.compile_cache import maybe_enable_compile_cache

    maybe_enable_compile_cache()  # TSDIFF_COMPILE_CACHE
    from tsdiff_tpu_torch.core.graph import from_numpy_graphs
    from tsdiff_tpu_torch.data.dataset import default_buckets, load_dataset, pick_bucket, tier_ladder
    from tsdiff_tpu_torch.data.featurize import featurize_smarts_list
    from tsdiff_tpu_torch.diffusion.captured import WalkRunner, can_capture
    from tsdiff_tpu_torch.diffusion.dual_objective import DualWalk
    from tsdiff_tpu_torch.diffusion.ensemble import load_members, make_ensemble
    from tsdiff_tpu_torch.diffusion.sampler import SamplingSettings, rescale_trajectory
    from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
    from tsdiff_tpu_torch.parallel import multihost
    from tsdiff_tpu_torch.parallel.sharding import batch_spec, take
    from tsdiff_tpu_torch.utils.misc import get_logger, resolve_device

    device = resolve_device(args.device)
    if args.quant != "none" and not args.fused_score:
        raise ValueError("--quant requires --fused_score")
    mesh, device = setup_mesh(args, len(args.ckpt), device)
    is_coord = multihost.is_coordinator()
    os.makedirs(args.save_dir, exist_ok=True)
    # only rank 0 logs progress (and writes the results)
    logger = get_logger("sampling", args.save_dir if is_coord else None)
    if not is_coord:
        logger.setLevel(logging.WARNING)
    logger.info(args)
    if mesh is not None:
        logger.info("Sampling on a (dp=%d, ens=%d) mesh of %d ranks over %s"
                    % (mesh.dp, mesh.ens, multihost.process_count(), mesh.backend))

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    logger.info("Loading checkpoints...")
    members, model_cfg = load_members(args.ckpt, device, dtype, fused_score=args.fused_score,
                                      quant=args.quant, use_ema=args.use_ema, logger=logger,
                                      mesh=mesh)
    # dsm models walk their sigma ladder and may have no beta schedule
    schedule = DiffusionSchedule.from_config(model_cfg) if "beta_schedule" in model_cfg else None
    dual = model_cfg.network == "dualenc"
    dsm = dual and model_cfg.type == "dsm"
    if dsm and args.timestep_respacing is not None:
        logger.warning("--timestep_respacing only applies to the DDPM schedule walk; dsm models "
                       "respace their sigma ladder instead: pass --sigma_respacing M or reduce "
                       "--n_steps per level")

    logger.info("Loading test set...")
    if args.test_set.endswith((".pkl", ".pck")):
        test_set, _ = load_dataset(args.test_set)
    else:
        if args.test_set.endswith(".txt"):
            with open(args.test_set) as f:
                smarts_list = f.read().strip().split("\n")
        else:
            smarts_list = [args.test_set]
        with open(args.feat_dict, "rb") as f:
            feat_dict = pickle.load(f)
        test_set = featurize_smarts_list(smarts_list, feat_dict)
    test_set = [g for i, g in enumerate(test_set) if args.start_idx <= i < args.end_idx]
    if args.sort_by_size:
        test_set = sorted(test_set, key=lambda g: int(g["atom_type"].shape[0]))
    logger.info(f"{len(test_set)} reactions selected")

    results = []
    if args.resume is not None:
        if multihost.process_count() > 1 and not os.path.exists(args.resume):
            # every rank derives the remaining reactions from the same file;
            # a pickle on rank 0's disk alone would desync the ranks
            raise SystemExit(
                f"--resume {args.resume}: not found on rank {torch.distributed.get_rank()}. "
                "Under --multihost the resume pickle must be on a path visible to ALL "
                "ranks (shared filesystem, or copy it to each host first)."
            )
        with open(args.resume, "rb") as f:
            results = pickle.load(f)
        done_smiles = {g.get("smiles") for g in results}
        test_set = [g for g in test_set if g.get("smiles") not in done_smiles]
        logger.info(f"Resumed {len(results)} results; {len(test_set)} remaining")
    if not test_set:
        logger.info("nothing to sample")

    buckets = default_buckets(max((int(g["atom_type"].shape[0]) for g in test_set), default=8))
    # each batch is padded up to a row tier with duplicates of its last
    # reaction (dropped when unbatching), so only a few shapes occur; every
    # tier is a multiple of dp, so that the rows split evenly
    dp = mesh.dp if mesh is not None else 1
    base_tier = _ceil_to(args.batch_size, dp)
    tiers = tier_ladder(base_tier, dp, max_tiers=3)

    def _tier(n: int) -> int:
        return min((t for t in tiers if t >= n), default=base_tier)

    def make_settings(clip: float) -> SamplingSettings:
        return SamplingSettings(
            sampling_type=args.sampling_type,
            n_steps=args.n_steps,
            step_lr=args.step_lr,
            clip=clip,
            eta=args.eta,
            denoise_from_time_t=args.denoise_from_time_t,
            noise_from_time_t=args.noise_from_time_t,
            save_traj=args.save_traj,
            timestep_respacing=args.timestep_respacing,
        )

    ensemble = make_ensemble(members, mesh)
    if capture and device.type == "cuda" and not can_capture(device, mesh):
        logger.info("Gloo collectives cannot be captured in a CUDA graph: walking eagerly")
    capture = capture and can_capture(device, mesh)
    pool = torch.cuda.graph_pool_handle() if capture else None
    runners: dict[tuple, WalkRunner] = {}

    def walk_of(settings: SamplingSettings) -> dict:
        """The dual encoder's walk of ``settings`` as the runner's ``walk``;
        the condensed model takes the runner's default."""
        if dsm:
            return {"walk": DualWalk.dsm(ensemble.model.sigmas, n_steps=args.n_steps,
                                         step_lr=args.step_lr, clip=settings.clip,
                                         sigma_respacing=args.sigma_respacing)}
        return {"walk": DualWalk.diffusion(schedule, settings)} if dual else {}

    def get_runner(n_pad: int, tier: int, clip: float) -> WalkRunner:
        key = (n_pad, tier, clip)
        if key not in runners:
            settings = make_settings(clip)
            runners[key] = WalkRunner(ensemble, schedule, settings, capture, pool,
                                      step_draws=True, mesh=mesh, **walk_of(settings))
        return runners[key]

    def sample_batch(gpad: list[dict], n_pad: int, clip: float):
        """``(physical-frame positions, NaN flag, trajectory or None)``; on a
        mesh this rank packs and walks its rows and gets every rank's."""
        rows = gpad if mesh is None else take(gpad, batch_spec(mesh))
        batch = from_numpy_graphs(rows, max_nodes=n_pad, device=device)
        settings = make_settings(clip)
        gen = torch.Generator(device=device)
        if args.from_ts_guess:
            if args.denoise_from_time_t is None:
                raise ValueError("--from_ts_guess needs --denoise_from_time_t")
            guess_key = "ts_guess" if "ts_guess" in gpad[0] else "pos"
            pos_init = np.zeros((len(gpad), n_pad, 3), np.float32)
            for b, g in enumerate(gpad):
                pos_init[b, : len(g[guess_key])] = g[guess_key]
            start_t = (
                args.noise_from_time_t if args.noise_from_time_t is not None
                else args.denoise_from_time_t
            )
            sqrt_a = float(np.sqrt(schedule.alphas[start_t - 1])) if start_t != 0 else 1.0
            pos_init = torch.from_numpy(pos_init).to(device) / sqrt_a
        else:
            gen.manual_seed(args.seed + len(results))
            pos_init = torch.randn((len(gpad), n_pad, 3), generator=gen, device=device)
        gen.manual_seed(args.seed * 7919 + len(results))
        runner = get_runner(n_pad, len(gpad), clip)
        pos, nan = runner.run(batch, pos_init, gen)
        traj = None
        if args.save_traj:
            traj = runner.trajectory(len(gpad))
            if not dsm:  # a dsm walk has no frame to rescale
                traj = rescale_trajectory(traj, schedule, settings)
            traj = traj.cpu().numpy()
        return pos, nan, traj

    for graphs in batching(test_set, args.batch_size, args.repeat):
        gpad = list(graphs) + [graphs[-1]] * (_tier(len(graphs)) - len(graphs))
        n_pad = max(pick_bucket(int(g["atom_type"].shape[0]), buckets) for g in gpad)
        for attempt, clip in enumerate([args.clip, 20.0]):  # retry at clip=20 on NaN
            pos, nan_persisted, traj = sample_batch(gpad, n_pad, clip)
            if not nan_persisted:
                break
            if attempt == 0:
                logger.warning("NaN detected; retrying with clipping thresh 20.")
        if nan_persisted:
            logger.error("NaN persisted after the clip-20 retry; batch results are "
                         "flagged nan_persisted=True.")
        for b, g in enumerate(graphs):
            n = int(g["atom_type"].shape[0])
            out = dict(g)
            out["pos_gen"] = traj[:, b, :n] if traj is not None else pos[b, :n]
            out["sampling_attempts"] = attempt + 1
            if nan_persisted:
                out["nan_persisted"] = True
            results.append(out)
        if is_coord:
            with open(os.path.join(args.save_dir, "samples_not_all.pkl"), "wb") as f:
                pickle.dump(results, f)

    if capture:
        logger.info("CUDA graphs recorded: %d, one per (bucket, tier, clip): %s" % (
            sum(r.captures for r in runners.values()),
            ", ".join(str(k) for k, r in runners.items() if r.captures)))
    logger.info("Walk rounds flagged NaN: %d" % sum(r.nan_rounds for r in runners.values()))
    save_path = os.path.join(args.save_dir, "samples_all.pkl")
    if is_coord:
        partial = os.path.join(args.save_dir, "samples_not_all.pkl")
        if os.path.exists(partial):
            os.remove(partial)
        logger.info("Saving samples to: %s" % save_path)
        with open(save_path, "wb") as f:
            pickle.dump(results, f)
    return save_path


if __name__ == "__main__":
    main()
