"""Device-resident training corpus: upload once, gather batches on the device.

Port of ``tsdiff_tpu/data/resident.py``.  The input pipeline becomes three
pieces:

* ``DeviceResidentData`` packs the corpus once on the host into dense arrays
  per bucket, in the uint8 wire format for the one-hot features, atom and
  bond types (float32 positions), with one all-zero "empty graph" row per
  bucket as the padding target of tail batches (``PaddedBatchLoader``'s
  empty-graph padding); ``nbytes`` is known before anything moves, and
  ``max_bytes`` raises ``CorpusTooLarge`` before any upload;
* per-epoch batch plans: a permutation of each bucket's graph indices padded
  to whole batches with the empty-row index.  The permutation is drawn from
  a ``torch.Generator`` seeded from (seed, epoch, bucket); JAX's PRNG cannot
  be reproduced in torch, so the draw differs from the JAX package's (the
  plan's form, the schedule and the validation plans are the same);
* ``gather_batch`` slices a plan at a cursor counting batches and gathers
  the batch from the resident arrays on their device.  The cursor is a
  0-dim device tensor, read on the device as JAX's traced cursor is, so a
  CUDA graph of the step replays it at every cursor; the plan is then a
  buffer whose address stays, a new epoch's plan copied into it.  A Python
  int cursor slices on the host.

Per step nothing crosses between host and device; a plan moves once per
bucket and epoch, from pinned memory, without the host waiting for it.
"""

from __future__ import annotations

import numpy as np
import torch

from tsdiff_tpu_torch.core.graph import ReactionBatch
from tsdiff_tpu_torch.data.dataset import default_buckets, pick_bucket

FIELDS = ("atom_type", "r_feat", "p_feat", "pos", "bond_mat", "node_mask")


class CorpusTooLarge(Exception):
    """The packed corpus exceeds the caller's byte budget.  Raised before any
    upload, so that the caller can stream instead."""


def _wire(a, what: str) -> np.ndarray:
    a = np.asarray(a)
    if a.max(initial=0) > 255 or a.min(initial=0) < 0:
        raise ValueError(f"{what} exceed the uint8 wire format")
    return a


class DeviceResidentData:
    """A corpus packed per bucket, resident on ``device`` after ``upload``.

    ``graphs``: numpy graph dicts (the on-disk format, ``data/dataset.py``);
    ``batch_size``: graphs per batch; ``bucket_sizes``: as
    ``PaddedBatchLoader``'s; ``seed``: the base of the per-epoch plans."""

    def __init__(self, graphs, batch_size: int, bucket_sizes=None, seed: int = 0,
                 device="cpu", max_bytes: int | None = None, upload: bool = True):
        if len(graphs) == 0:
            raise ValueError("empty corpus")
        self.batch_size = int(batch_size)
        max_nodes = max(int(np.asarray(g["atom_type"]).shape[0]) for g in graphs)
        if bucket_sizes is None:
            bucket_sizes = default_buckets(max_nodes)
        self.bucket_sizes = sorted(int(b) for b in bucket_sizes)
        self.feat_dim = int(np.asarray(graphs[0]["r_feat"]).shape[-1])
        self.device = torch.device(device)
        self.seed = int(seed)

        by_bucket: dict[int, list[dict]] = {b: [] for b in self.bucket_sizes}
        for g in graphs:
            by_bucket[pick_bucket(int(np.asarray(g["atom_type"]).shape[0]),
                                  self.bucket_sizes)].append(g)
        host: dict[int, dict[str, np.ndarray]] = {}
        self.n_graphs: dict[int, int] = {}
        self.n_batches: dict[int, int] = {}
        F = self.feat_dim
        for bsize, gs in by_bucket.items():
            if not gs:
                continue
            M = len(gs)
            # row M: the all-zero empty graph that pads tail batches
            arrs = dict(
                atom_type=np.zeros((M + 1, bsize), np.uint8),
                r_feat=np.zeros((M + 1, bsize, F), np.uint8),
                p_feat=np.zeros((M + 1, bsize, F), np.uint8),
                pos=np.zeros((M + 1, bsize, 3), np.float32),
                bond_mat=np.zeros((M + 1, bsize, bsize), np.uint8),
                node_mask=np.zeros((M + 1, bsize), bool),
            )
            for i, g in enumerate(gs):
                n = int(np.asarray(g["atom_type"]).shape[0])
                arrs["atom_type"][i, :n] = _wire(g["atom_type"], "atom types")
                arrs["r_feat"][i, :n] = _wire(g["r_feat"], "one-hot features")
                arrs["p_feat"][i, :n] = _wire(g["p_feat"], "one-hot features")
                if g.get("pos") is not None:
                    arrs["pos"][i, :n] = g["pos"]
                if "bond_mat" in g:
                    arrs["bond_mat"][i, :n, :n] = _wire(g["bond_mat"], "bond types")
                else:
                    ei = np.asarray(g["edge_index"])
                    arrs["bond_mat"][i, ei[0], ei[1]] = _wire(g["edge_type"], "bond types")
                arrs["node_mask"][i, :n] = True
            host[bsize] = arrs
            self.n_graphs[bsize] = M
            self.n_batches[bsize] = -(-M // self.batch_size)

        self._nbytes = sum(a.nbytes for arrs in host.values() for a in arrs.values())
        if max_bytes is not None and self._nbytes > max_bytes:
            raise CorpusTooLarge(f"packed corpus is {self._nbytes / 1e9:.2f} GB "
                                 f"(> {max_bytes / 1e9:.2f} GB budget)")
        self._host: dict[int, dict[str, np.ndarray]] | None = host
        self.buckets: dict[int, dict[str, torch.Tensor]] = {}
        if upload:
            self.upload()

    @property
    def nbytes(self) -> int:
        return self._nbytes

    def upload(self) -> "DeviceResidentData":
        """Move the packed corpus to the device (idempotent).  With
        ``upload=False`` a caller checks ``nbytes`` of several corpora against
        one budget first."""
        if self._host is None:
            return self
        self.buckets = {b: {k: torch.from_numpy(a).to(self.device) for k, a in arrs.items()}
                        for b, arrs in self._host.items()}
        self._host = None
        return self

    def epoch_schedule(self) -> list[int]:
        """The bucket of every batch of one epoch, buckets in ascending order
        (``PaddedBatchLoader``'s visiting order)."""
        return [b for b in self.bucket_sizes for _ in range(self.n_batches.get(b, 0))]

    def real_graphs(self, bsize: int, cursor: int) -> int:
        """The real (not padding) graphs of batch ``cursor`` of a bucket's plan."""
        c = cursor % self.n_batches[bsize]
        return min(self.batch_size, self.n_graphs[bsize] - c * self.batch_size)

    def _padded(self, bsize: int, order: torch.Tensor) -> torch.Tensor:
        M = self.n_graphs[bsize]
        pad = torch.full((self.n_batches[bsize] * self.batch_size - M,), M, dtype=torch.int64)
        plan = torch.cat([order, pad])
        if self.device.type == "cuda":   # a copy queued behind the steps, the host not waiting
            return plan.pin_memory().to(self.device, non_blocking=True)
        return plan

    def make_plan(self, bsize: int, epoch: int) -> torch.Tensor:
        """One bucket's plan for ``epoch``: a permutation of its graph indices,
        padded to whole batches with the empty-row index, on the device."""
        seed = int(np.random.SeedSequence([self.seed, int(epoch), int(bsize)]).generate_state(1)[0])
        gen = torch.Generator().manual_seed(seed)
        return self._padded(bsize, torch.randperm(self.n_graphs[bsize], generator=gen))

    def fixed_plan(self, bsize: int) -> torch.Tensor:
        """The unshuffled plan (validation): corpus order, then padding."""
        return self._padded(bsize, torch.arange(self.n_graphs[bsize]))


def gather_batch(arrays: dict, plan: torch.Tensor, cursor: int | torch.Tensor,
                 batch_size: int, rows: slice | None = None) -> ReactionBatch:
    """Batch ``cursor`` (wrapped modulo the plan's batches) of ``plan``,
    gathered from the resident ``arrays`` on their device, in the dtypes of
    ``from_numpy_graphs``: int64 atom and bond types, uint8 features, float32
    positions, a bool mask.  ``cursor``: a 0-dim integer tensor on the
    plan's device (the slot computed there) or a Python int.  ``rows``: only
    these rows of the batch (a data-parallel rank's block; every rank holds
    the whole corpus and gathers at ``slot + rows.start``)."""
    start, stop = (0, batch_size) if rows is None else (rows.start, rows.stop)
    slot = (cursor % (plan.shape[0] // batch_size)) * batch_size + start
    if isinstance(slot, torch.Tensor):
        idx = plan.index_select(0, slot + torch.arange(stop - start, device=plan.device))
    else:
        idx = plan[slot:slot + stop - start]
    rows = {k: arrays[k].index_select(0, idx) for k in FIELDS}
    rows["atom_type"] = rows["atom_type"].long()
    rows["bond_mat"] = rows["bond_mat"].long()
    return ReactionBatch(**rows)
