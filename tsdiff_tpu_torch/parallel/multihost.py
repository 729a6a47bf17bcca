"""Multi-process runs: one process (rank) per GPU over ``torch.distributed``.

Port of ``tsdiff_tpu/parallel/multihost.py``.  JAX runs one process per host
and stitches the hosts' devices into one global device set; PyTorch runs one
process per GPU, so every multi-device run here is a multi-process run:

  * :func:`initialize` — the process group.  ``--coordinator H:P --nprocs n
    --procid i`` becomes ``init_process_group(init_method="tcp://H:P",
    world_size=n, rank=i)``; with none of the three, the environment that
    ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) through ``env://``.  The backend is NCCL on CUDA and
    Gloo on the CPU; two ranks may share one card only over Gloo.  Each rank
    runs on ``cuda:{LOCAL_RANK}``, else ``cuda:{rank % device_count}``;
  * :func:`is_coordinator` — gate checkpoint writes and logging to rank 0;
  * :func:`make_global_batch` / :func:`global_from_full` — identical full host
    copies on every rank -> this rank's block on its device;
  * :func:`replicate_output` — the ``dp``-sharded rows of every rank on every
    rank, as one ``all_reduce(SUM)`` of a zero-filled global buffer (exact:
    x + 0 = x; Gloo has no all-gather of CUDA tensors).

Determinism contract (how every rank stays on the same program): each rank
builds the identical global batch sequence (same corpus file, same seed,
same bucket schedule) and feeds its own rows of it.  The ranks record the
same CUDA graphs in the same order, so their collectives line up.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from tsdiff_tpu_torch.parallel.sharding import Mesh, Spec, batch_spec, replicated_spec, take
from tsdiff_tpu_torch.utils.misc import map_tree

#: how long a collective or the rendezvous waits before it fails
TIMEOUT = datetime.timedelta(seconds=float(os.environ.get("TSDIFF_DIST_TIMEOUT_S", 600)))
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def launched_by_torchrun() -> bool:
    return all(k in os.environ for k in TORCHRUN_ENV)


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device="cuda",
    backend: str | None = None,
) -> torch.device:
    """Join the process group and pick this rank's device; returns it.

    ``device``: the entry point's device type (``cuda`` or ``cpu``).
    ``backend``: ``nccl`` or ``gloo``; default NCCL on CUDA, Gloo on the CPU.
    The three cluster flags are given all together, or none of them (then
    ``torchrun``'s environment)."""
    if coordinator is None and (num_processes is not None or process_id is not None):
        raise ValueError(
            "--nprocs/--procid were given without --coordinator; explicit "
            "cluster flags require all three (under torchrun omit all three "
            "and the cluster is read from its environment)"
        )
    if coordinator is not None and (num_processes is None or process_id is None):
        raise ValueError(
            "--coordinator was given without --nprocs/--procid; explicit "
            "cluster flags require all three (under torchrun omit all three "
            "and the cluster is read from its environment)"
        )
    if coordinator is None and not launched_by_torchrun():
        raise ValueError(
            "--multihost without --coordinator/--nprocs/--procid needs the "
            f"environment torchrun sets ({', '.join(TORCHRUN_ENV)})"
        )
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r}: nccl or gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs CUDA devices; use gloo on the CPU")
    rank = process_id if coordinator is not None else int(os.environ["RANK"])
    if device.type == "cuda":
        index = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    if coordinator is not None:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id, timeout=TIMEOUT)
    else:
        dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
    return device


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_global_batch(batch, mesh: Mesh):
    """The IDENTICAL global batch on every rank -> this rank's rows over the
    data axes, on its device."""
    return global_from_full(batch, batch_spec(mesh), mesh.device)


def make_replicated(tree, mesh: Mesh):
    """Identical per-rank copies -> the whole of each, on the rank's device."""
    return global_from_full(tree, replicated_spec(mesh), mesh.device)


def global_from_full(tree, spec: Spec, device):
    """IDENTICAL full host arrays on every rank -> ``spec``'s block of each,
    as tensors on ``device`` (numpy arrays converted)."""
    def put(x):
        return (torch.from_numpy(x) if isinstance(x, np.ndarray) else x).to(device)

    return map_tree(put, take(tree, spec))


def global_key(seed: int, mesh: Mesh | None = None) -> torch.Generator:
    """A generator seeded alike on every rank (on the mesh's device): every
    rank draws the same global values and keeps its own block of them."""
    device = mesh.device if mesh is not None else "cpu"
    return torch.Generator(device=device).manual_seed(int(seed))


def replicate_output(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's ``dp`` rows of a global array (leading axis) -> the whole
    array on every rank.  All ranks must call it (a collective): one
    all-reduce of a zero-filled global buffer into which the first rank of
    each data block (``ens`` index 0) wrote its rows."""
    rows = x.shape[0]
    full = x.new_zeros((rows * mesh.dp, *x.shape[1:]))
    if mesh.coords.get("ens", 0) == 0:
        full[mesh.dp_index * rows:(mesh.dp_index + 1) * rows] = x
    dist.all_reduce(full)
    return full
