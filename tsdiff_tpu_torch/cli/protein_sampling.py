"""Full-protein sidechain generation CLI on PyTorch.

    python -m tsdiff_tpu_torch.cli.protein_sampling CKPT \
        --protein_set proteins.pkl --save_dir generated [--write_pdb] ...

Port of ``tsdiff_tpu/cli/protein_sampling.py``: loads a sidechain dataset
built by ``preprocessing --pdb_glob`` and a dual-encoder checkpoint (``dsm``
or ``diffusion``; a ``.ckpt`` or a reference ``.pt``), regenerates every
sidechain of each protein from noise with the backbone pinned
(``diffusion/protein.py``), retries a protein once at clip 20 when its walk
flags a NaN, and writes ``proteins_gen.pkl`` (one entry per protein:
``pos_gen``, ``pos_gt``, ``is_sidechain``, ``coverage_counts``, ``nan`` and
the identity columns ``evaluate --protein`` needs) and, with
``--write_pdb``, one regenerated ``.pdb`` per protein.

Each batch shape's walk step replays one CUDA graph on the card, recorded
at its first batch; ``--device cpu`` walks eagerly.
Protein ``i`` draws from a generator seeded ``--seed + i`` and is covered
with the same seed; its retry uses ``--seed + i + 7919`` for both.

Several GPUs: one rank per GPU (``torchrun --nproc_per_node G -m
tsdiff_tpu_torch.cli.protein_sampling ...``, or ``--multihost --coordinator
H:P --nprocs n --procid i`` for each); the covering batches split over
``dp`` (``--mesh auto``: the largest divisor of ``--batch_size`` up to the
ranks, which must then be all of them), the tail batch padded to
``--batch_size``.  Every rank draws the whole batch's noise, so the result
is that of one process, bit for bit.  Only rank 0 writes.
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle

import numpy as np
import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("ckpt", type=str, help="dualenc checkpoint (dsm or diffusion)")
    parser.add_argument("--protein_set", type=str, required=True)
    parser.add_argument("--save_dir", type=str, required=True)
    parser.add_argument("--start_idx", type=int, default=0)
    parser.add_argument("--end_idx", type=int, default=9999)
    parser.add_argument("--cutoff", type=float, default=10.0,
                        help="subgraph-covering ball radius (A)")
    parser.add_argument("--batch_size", type=int, default=8, help="subgraphs per device batch")
    parser.add_argument("--n_steps", type=int, default=None,
                        help="dsm: steps per sigma level (default 100); diffusion: steps of "
                             "the schedule, default all")
    parser.add_argument("--step_lr", type=float, default=1e-6)
    parser.add_argument("--sigma_respacing", type=int, default=None,
                        help="DSM ladder respacing: anneal through an evenly strided m-level "
                             "subsequence of the sigma ladder (ends kept)")
    parser.add_argument("--global_start_sigma", type=float, default=float("inf"))
    parser.add_argument("--w_global", type=float, default=0.2)
    parser.add_argument("--clip", type=float, default=1000.0)
    parser.add_argument("--seed", type=int, default=2022)
    parser.add_argument("--use_ema", action="store_true", default=False)
    parser.add_argument("--mesh", type=str, default="auto",
                        help="'auto' splits the subgraph batches over all ranks dividing "
                             "--batch_size; 'none' disables; or an explicit dp count")
    parser.add_argument("--write_pdb", action="store_true", default=False,
                        help="also write <save_dir>/<index>_<name>_gen.pdb per protein")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--multihost", action="store_true", default=False,
                        help="multi-process sampling, one rank per GPU; only rank 0 writes. "
                             "Pass --coordinator/--nprocs/--procid, or omit all three under "
                             "torchrun")
    parser.add_argument("--coordinator", type=str, default=None, help="host:port of rank 0")
    parser.add_argument("--nprocs", type=int, default=None, help="number of ranks")
    parser.add_argument("--procid", type=int, default=None, help="this process's rank")
    parser.add_argument("--dist_backend", type=str, default=None, choices=["nccl", "gloo"],
                        help="collectives' backend (default: nccl on cuda, gloo on cpu)")
    return parser.parse_args(argv)


def setup_mesh(args, device):
    """``(mesh or None, device)`` of ``--mesh``, with the JAX CLI's checks
    (``tsdiff_tpu/cli/protein_sampling.py:86-125``); joins the process group
    first under ``--multihost`` or ``torchrun``."""
    from tsdiff_tpu_torch.parallel import make_mesh, multihost

    if args.multihost or multihost.launched_by_torchrun():
        device = multihost.initialize(args.coordinator, args.nprocs, args.procid,
                                      device=device, backend=args.dist_backend)
    n_dev = multihost.process_count()
    if args.mesh == "none":  # every rank samples every protein; rank 0 writes
        return None, device
    if args.mesh == "auto":
        dp = max(d for d in range(1, n_dev + 1) if args.batch_size % d == 0)
    else:
        try:
            dp = int(args.mesh)
        except ValueError:
            raise SystemExit(f"--mesh must be 'auto', 'none' or an integer, got {args.mesh!r}")
        if dp < 1 or dp > n_dev:
            raise SystemExit(f"--mesh {dp} outside 1..{n_dev} available ranks")
        if args.batch_size % dp != 0:
            raise SystemExit(f"--batch_size {args.batch_size} not divisible by --mesh {dp}")
    if n_dev > 1 and dp != n_dev:
        raise SystemExit(
            f"--multihost requires the mesh to span all {n_dev} ranks (got dp={dp}; pass "
            f"--mesh {n_dev}, or 'auto', with --batch_size divisible by {n_dev})")
    if dp == 1:
        return None, device
    return make_mesh(dp=dp, ens=1, device=device), device


def main(argv=None, capture: bool = True) -> str:
    """Sample; returns the path of ``proteins_gen.pkl``.  ``capture=False``
    walks eagerly on CUDA too."""
    args = parse_args(argv)

    from tsdiff_tpu_torch.data.dataset import load_dataset
    from tsdiff_tpu_torch.data.pdb import write_pdb
    from tsdiff_tpu_torch.diffusion.captured import can_capture
    from tsdiff_tpu_torch.diffusion.ensemble import load_members
    from tsdiff_tpu_torch.diffusion.protein import sample_protein_sidechains
    from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
    from tsdiff_tpu_torch.parallel import multihost
    from tsdiff_tpu_torch.utils.misc import get_logger, resolve_device, seed_all

    device = resolve_device(args.device)
    mesh, device = setup_mesh(args, device)
    is_coord = multihost.is_coordinator()
    os.makedirs(args.save_dir, exist_ok=True)
    logger = get_logger("protein_sampling", args.save_dir if is_coord else None)
    if not is_coord:
        logger.setLevel(logging.WARNING)
    logger.info(args)
    if mesh is not None:
        logger.info(f"subgraph batches split over dp={mesh.dp} ranks over {mesh.backend}")

    members, model_cfg = load_members([args.ckpt], device, torch.float32,
                                      use_ema=args.use_ema, logger=logger)
    model = members[0]
    if model_cfg.network != "dualenc":
        raise SystemExit(f"{args.ckpt}: protein sampling needs a dualenc model, "
                         f"not {model_cfg.network}")
    schedule = DiffusionSchedule.from_config(model_cfg) if model.model_type == "diffusion" \
        else None
    seed_all(args.seed)
    if capture and device.type == "cuda" and not can_capture(device, mesh):
        logger.info("Gloo collectives cannot be captured in a CUDA graph: walking eagerly")
    capture = capture and can_capture(device, mesh)
    pool = torch.cuda.graph_pool_handle() if capture else None
    runners: dict = {}

    graphs, _ = load_dataset(args.protein_set)
    graphs = graphs[args.start_idx:args.end_idx]
    logger.info(f"{len(graphs)} proteins selected")

    def sample(g, seed: int, clip: float):
        gen = torch.Generator(device=device).manual_seed(seed)
        return sample_protein_sidechains(
            model, g, gen, schedule=schedule, cutoff=args.cutoff, batch_size=args.batch_size,
            n_steps=args.n_steps, step_lr=args.step_lr,
            global_start_sigma=args.global_start_sigma, w_global=args.w_global, clip=clip,
            seed=seed, mesh=mesh, sigma_respacing=args.sigma_respacing, capture=capture,
            runners=runners, pool=pool)

    results = []
    for i, g in enumerate(graphs):
        pos_gen, counts, nan = sample(g, args.seed + i, args.clip)
        if nan:  # as the sampling CLI: one retry at clip 20
            logger.warning("NaN during sampling; retrying with clip=20")
            pos_gen, counts, nan = sample(g, args.seed + i + 7919, 20.0)
        sc = np.asarray(g["is_sidechain"], bool)
        d = np.linalg.norm(pos_gen[sc] - np.asarray(g["pos"])[sc], axis=-1)
        name = g.get("smiles") or f"protein_{args.start_idx + i}"
        logger.info(
            f"[{i + 1}/{len(graphs)}] {name}: sidechain RMSD "
            f"{float(np.sqrt((d ** 2).mean())):.3f} A, "
            f"covered {int((counts > 0).sum())}/{int(sc.sum())} sidechain atoms"
            + (", NaN flagged" if nan else ""))
        entry = dict(name=name, pos_gen=pos_gen, pos_gt=np.asarray(g["pos"]),
                     is_sidechain=sc, coverage_counts=counts, nan=bool(nan))
        # the identity columns ride along for evaluate --protein's chi1
        for col in ("atom_name", "res_name", "atom2res"):
            if col in g:
                entry[col] = g[col]
        results.append(entry)
        if args.write_pdb and is_coord:
            # the index prefix keeps proteins with one basename apart
            base = os.path.basename(str(name)) or "protein"
            out_pdb = os.path.join(args.save_dir, f"{args.start_idx + i:04d}_{base}_gen.pdb")
            with open(out_pdb, "w") as f:
                f.write(write_pdb(g, pos_gen))

    if capture:
        logger.info("CUDA graphs recorded: %d, one per (nodes, clip, batch rows): %s" % (
            sum(r.captures for r in runners.values()),
            ", ".join(f"{k} {sorted(r.rounds())}" for k, r in runners.items() if r.captures)))
    out = os.path.join(args.save_dir, "proteins_gen.pkl")
    if is_coord:
        with open(out, "wb") as f:
            pickle.dump(results, f)
        logger.info(f"Saved {len(results)} results to {out}")
    return out


if __name__ == "__main__":
    main()
