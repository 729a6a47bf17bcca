"""The (dp, ens) mesh of processes: data-parallel training, ensemble-parallel
sampling.

Port of ``tsdiff_tpu/parallel/sharding.py``.  JAX runs one process over
every local device and XLA places the collectives; PyTorch runs one
process per GPU (a *rank*), so a mesh here is a layout of ranks:

* ``make_mesh``: ranks ``0 .. dp*ens-1`` laid out row-major as a
  ``(dp, ens)`` array, as JAX reshapes its device list: rank ``r`` holds
  data block ``r // ens`` and member block ``r % ens``.
  ``make_hybrid_mesh``: ``(dp_dcn, dp, ens)``, the outer axis over nodes
  (a node is ``LOCAL_WORLD_SIZE`` ranks, as ``torchrun`` starts them).
* The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the JAX
  axis names; each named axis has its sub-group (``Mesh.group``), and the
  data axes together one more (``Mesh.data_group``).  One eager collective
  on every group at construction creates the communicators, so that a CUDA
  graph recorded later can capture NCCL collectives.
* A JAX ``NamedSharding`` becomes a ``Spec``: the block of a leading axis
  that this rank owns, plus the group the axis reduces over.
  ``batch_spec``: the rank's rows over the data axes; ``ens_spec``: its
  members; ``replicated_spec``: everything, no reduction.
* ``shard_batch`` keeps the rank's rows of a batch, ``shard_ensemble_params``
  its members of a stacked parameter dict or a member list, ``replicate``
  broadcasts rank 0's tensors to every rank.

Every rank builds the same mesh, in the same order of calls, from
``torch.distributed``'s default group (``parallel/multihost.py``).
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist

from tsdiff_tpu_torch.utils.misc import map_tree

#: the data-parallel axes, outermost first
DATA_AXES = ("dp_dcn", "dp")


@dataclasses.dataclass(frozen=True)
class Spec:
    """This rank's block of a leading axis split into ``blocks`` equal blocks,
    and the group that reduces over that axis (None: not split)."""

    blocks: int = 1
    block: int = 0
    group: object = None

    def slice(self, n: int) -> slice:
        """The rows (or members) of an axis of length ``n`` this rank owns."""
        if n % self.blocks:
            raise ValueError(f"an axis of {n} does not split into {self.blocks} equal blocks")
        size = n // self.blocks
        return slice(self.block * size, (self.block + 1) * size)


class Mesh:
    """A ``DeviceMesh`` of the world's ranks with named axes, its sub-groups
    and this rank's coordinates.  ``device``: this rank's device."""

    def __init__(self, shape: dict[str, int], device):
        self.device = torch.device(device)
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        world = dist.get_world_size()
        if math.prod(self.shape.values()) != world:
            raise ValueError(f"mesh {self.shape} does not span the {world} ranks of the world")
        from torch.distributed.device_mesh import DeviceMesh

        layout = torch.arange(world, dtype=torch.int).reshape(tuple(self.shape.values()))
        self.device_mesh = DeviceMesh(self.device.type, layout, mesh_dim_names=self.axis_names)
        rank = dist.get_rank()
        self.coords = dict(zip(self.axis_names, (int(i) for i in torch.nonzero(layout == rank)[0])))
        self.backend = dist.get_backend()
        data = [a for a in DATA_AXES if a in self.shape]
        if len(data) == 1:
            self.data_group = self.group(data[0])
        else:
            # the data axes flattened: one group per ens column, every rank
            # creating all of them in the same order
            ens = self.shape.get("ens", 1)
            columns = [layout[..., e].flatten().tolist() for e in range(ens)]
            self.data_group, _ = dist.new_subgroups_by_enumeration(columns)
        self._warm_up()

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    @property
    def dp(self) -> int:
        """The data-parallel extent: the product of the data axes."""
        return math.prod(self.shape.get(a, 1) for a in DATA_AXES)

    @property
    def dp_index(self) -> int:
        """This rank's block over the data axes, outermost first."""
        index = 0
        for a in DATA_AXES:
            if a in self.shape:
                index = index * self.shape[a] + self.coords[a]
        return index

    @property
    def ens(self) -> int:
        return self.shape.get("ens", 1)

    def _warm_up(self) -> None:
        """One eager all-reduce on the world and on every group: NCCL makes a
        communicator at a group's first collective, which must not happen
        while a CUDA graph records."""
        x = torch.zeros(1, device=self.device)
        dist.all_reduce(x)
        for axis in self.axis_names:
            dist.all_reduce(x, group=self.group(axis))
        dist.all_reduce(x, group=self.data_group)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {dist.get_rank()} at {self.coords}, {self.backend})"


def make_mesh(dp: int | None = None, ens: int = 1, device=None) -> Mesh:
    """Mesh of shape (dp, ens) over the world's ranks.  ``dp=None`` uses all
    remaining ranks.  ``device``: this rank's device (default: the current
    CUDA device, else the CPU)."""
    n = dist.get_world_size()
    if dp is None:
        if n % ens:
            raise ValueError(f"{n} ranks not divisible by ens={ens}")
        dp = n // ens
    if dp * ens != n:
        raise ValueError(f"mesh {dp}x{ens} does not span the {n} ranks of the world")
    return Mesh({"dp": dp, "ens": ens}, _default_device(device))


def local_world_size() -> int:
    """Ranks per node: ``LOCAL_WORLD_SIZE`` as ``torchrun`` sets it, else the
    whole world (one node)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


def make_hybrid_mesh(ens: int = 1, dp: int | None = None, num_slices: int | None = None,
                     device=None) -> Mesh:
    """Multi-node mesh with axes ``("dp_dcn", "dp", "ens")``: ``dp_dcn`` spans
    the nodes (a JAX slice), so its gradient all-reduce crosses the network
    once per step, while ``dp`` and ``ens`` stay within a node.

    ``num_slices=None`` uses the nodes detected (``world //
    LOCAL_WORLD_SIZE``).  The per-node data axis ``dp=None`` uses all
    remaining ranks of a node."""
    n = dist.get_world_size()
    detected = max(1, n // local_world_size())
    if num_slices is None:
        num_slices = detected
    if detected > 1 and num_slices != detected:
        # a contiguous reshape here would let intra-node axes straddle nodes
        raise ValueError(
            f"num_slices={num_slices} but the launcher reports {detected} "
            "nodes; pass num_slices=None to auto-detect"
        )
    if n % num_slices:
        raise ValueError(f"{n} ranks not divisible by {num_slices} slices")
    per_slice = n // num_slices
    if dp is None:
        if per_slice % ens:
            raise ValueError(f"{per_slice}/slice not divisible by ens={ens}")
        dp = per_slice // ens
    if dp * ens != per_slice:
        raise ValueError(f"per-slice mesh {dp}x{ens} != {per_slice} ranks/slice")
    return Mesh({"dp_dcn": num_slices, "dp": dp, "ens": ens}, _default_device(device))


def _default_device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def batch_spec(mesh: Mesh) -> Spec:
    """The rank's rows over the data axes (``dp``, plus ``dp_dcn`` on hybrid
    meshes), reduced over ``mesh.data_group``."""
    return Spec(mesh.dp, mesh.dp_index, mesh.data_group if mesh.dp > 1 else None)


def ens_spec(mesh: Mesh) -> Spec:
    """The rank's members, reduced over the ``ens`` group."""
    return Spec(mesh.ens, mesh.coords.get("ens", 0), mesh.group("ens") if mesh.ens > 1 else None)


def replicated_spec(mesh: Mesh | None = None) -> Spec:
    return Spec()


def take(x, spec: Spec):
    """``spec``'s block of a list, or of the leading axis of every tensor or
    array in ``x`` (a tensor, array, or a dataclass or dict of them)."""
    if isinstance(x, list):
        return x[spec.slice(len(x))]
    return map_tree(lambda t: t[spec.slice(t.shape[0])], x)


def shard_batch(batch, mesh: Mesh):
    """The rank's rows of a ``ReactionBatch`` (leading graph axis split over
    the data axes)."""
    return take(batch, batch_spec(mesh))


def shard_ensemble_params(stacked, mesh: Mesh):
    """The rank's members: of a stacked name -> tensor dict (leading member
    axis) or of a list of members."""
    return take(stacked, ens_spec(mesh))


def replicate(tree, mesh: Mesh):
    """Every tensor of ``tree`` (a tensor, or a dict, list or dataclass of
    them) made equal to rank 0's, in place; returns ``tree``."""
    map_tree(lambda t: dist.broadcast(t, src=0), tree)
    return tree
