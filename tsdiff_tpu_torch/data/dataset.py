"""Datasets on disk and the shape buckets of padded batches.

The on-disk format is a pickle of plain-numpy graph dicts,
``{"format": "tsdiff_tpu.v1", "graphs": [...], "feat_dict": ...}``, or a bare
list of such dicts.  Graphs are padded to a small set of bucket sizes
(multiples of 8 atoms) and batches to a short ladder of row tiers, so a
sampling campaign sees only a few distinct shapes.  ``PaddedBatchLoader``
cuts a dataset into fixed-shape batches per bucket with the JAX package's
``np.random.default_rng(seed)`` plan, so both packages yield the same
batches.  The background prefetcher is ``data/prefetch.py``, the
device-resident corpus ``data/resident.py``.

``load_dataset`` also reads the reference's PyG pickles (datasets and
``samples_all.pkl``), through the stand-in modules of ``data/pyg_compat.py``
where torch_geometric or rdkit does not import, converted in memory.
"""

from __future__ import annotations

import pickle
from typing import Iterator, Sequence

import numpy as np

from tsdiff_tpu_torch.core.graph import from_numpy_graphs

FORMAT_TAG = "tsdiff_tpu.v1"


def save_dataset(path: str, graphs: list[dict], feat_dict=None, extra: dict | None = None):
    payload = {"format": FORMAT_TAG, "graphs": graphs, "feat_dict": feat_dict}
    if extra:
        payload.update(extra)
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_dataset(path: str) -> tuple[list[dict], dict | None]:
    """``(graphs, feat_dict)`` of a native ``tsdiff_tpu.v1`` pickle, a bare
    list of graph dicts, or a reference PyG pickle (list of ``Data``)."""
    try:
        with open(path, "rb") as f:
            payload = pickle.load(f)
    except (ImportError, AttributeError):
        # a reference PyG pickle names torch_geometric/rdkit classes: retry
        # with the stand-in modules installed
        from tsdiff_tpu_torch.data.pyg_compat import load_pyg_pickle

        payload = load_pyg_pickle(path)
    if isinstance(payload, dict) and payload.get("format") == FORMAT_TAG:
        return payload["graphs"], payload.get("feat_dict")
    if isinstance(payload, list) and payload:
        if isinstance(payload[0], dict):
            return payload, None
        from tsdiff_tpu_torch.data.convert import graphs_from_pyg_list

        try:
            return graphs_from_pyg_list(payload), None
        except (KeyError, TypeError) as e:
            raise ValueError(
                f"{path}: looks like a PyG pickle but is missing reaction fields ({e}); "
                "convert explicitly with python -m tsdiff_tpu_torch.data.convert dataset"
            ) from None
    raise ValueError(f"{path}: not a {FORMAT_TAG} or reference PyG dataset")


def pick_bucket(n: int, bucket_sizes: Sequence[int]) -> int:
    for b in bucket_sizes:
        if n <= b:
            return b
    raise ValueError(f"graph with {n} atoms exceeds the largest bucket {bucket_sizes[-1]}")


def default_buckets(max_nodes: int, multiple: int = 8) -> list[int]:
    """Bucket sizes: multiples of ``multiple`` up to max_nodes rounded up."""
    top = ((max_nodes + multiple - 1) // multiple) * multiple
    return list(range(multiple, top + 1, multiple))


def tier_ladder(base: int, dp: int = 1, max_tiers: int | None = None) -> list[int]:
    """Descending batch-row tiers: ``base`` halved (floor) while the result
    stays >= max(4, dp) and a multiple of dp; ``max_tiers`` caps the depth."""
    ladder = [int(base)]
    while ladder[-1] // 2 >= max(4, dp) and (ladder[-1] // 2) % dp == 0:
        if max_tiers is not None and len(ladder) >= max_tiers:
            break
        ladder.append(ladder[-1] // 2)
    return ladder


class TSDataset:
    """List-backed dataset of numpy graph dicts, from a list or a ``.pkl``."""

    def __init__(self, path_or_graphs):
        if isinstance(path_or_graphs, (list, tuple)):
            self.graphs = list(path_or_graphs)
            self.feat_dict = None
        else:
            self.graphs, self.feat_dict = load_dataset(path_or_graphs)

    def __len__(self) -> int:
        return len(self.graphs)

    def __getitem__(self, idx: int) -> dict:
        return self.graphs[idx]

    @property
    def max_nodes(self) -> int:
        return max(int(g["atom_type"].shape[0]) for g in self.graphs)


def _empty_graph(feat_dim: int, sidechain: bool = False) -> dict:
    """A zero-atom graph that pads a tail batch to full size.  ``sidechain``:
    it also carries an empty ``is_sidechain``, so that a padded protein
    batch keeps its mask (``from_numpy_graphs`` packs the mask when every
    graph has one).  The caller decides from its corpus, never from one
    batch: a data-parallel rank's rows of a tail batch may all be padding,
    and a captured step replays only batches with the fields it recorded."""
    graph = dict(
        atom_type=np.zeros((0,), np.int32),
        r_feat=np.zeros((0, feat_dim), np.float32),
        p_feat=np.zeros((0, feat_dim), np.float32),
        pos=np.zeros((0, 3), np.float32),
        edge_index=np.zeros((2, 0), np.int32),
        edge_type=np.zeros((0,), np.int32),
    )
    if sidechain:
        graph["is_sidechain"] = np.zeros((0,), bool)
    return graph


class PaddedBatchLoader:
    """Fixed-shape ``ReactionBatch``es on ``device``, bucketed by graph size.

    Every epoch: (optionally) shuffle, put each graph in the smallest bucket
    that fits, then emit batches of exactly ``batch_size`` graphs per bucket,
    a partial tail padded with empty graphs (or dropped with ``drop_tail``).
    With ``with_indices`` each batch comes with its dataset indices (-1 for
    padding).  ``rows``: pack only these rows of every batch (a data-parallel
    rank's block of the global plan, which every rank makes alike); the
    indices stay the whole batch's."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        bucket_sizes: Sequence[int] | None = None,
        seed: int = 0,
        drop_tail: bool = False,
        with_indices: bool = False,
        device="cpu",
        rows: slice | None = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.drop_tail = drop_tail
        self.with_indices = with_indices
        self.device = device
        self.rows = rows if rows is not None else slice(None)
        if bucket_sizes is None:
            bucket_sizes = default_buckets(dataset.max_nodes)
        self.bucket_sizes = sorted(bucket_sizes)
        self.feat_dim = int(dataset[0]["r_feat"].shape[-1])
        #: protein subgraphs: padding carries the mask too
        self.sidechain = "is_sidechain" in dataset[0]

    def __len__(self) -> int:
        return sum(1 for _ in self._plan())

    def _plan(self) -> Iterator[tuple[int, list[int]]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            order = self.rng.permutation(order)
        buckets: dict[int, list[int]] = {b: [] for b in self.bucket_sizes}
        for idx in order:
            n = int(self.dataset[int(idx)]["atom_type"].shape[0])
            buckets[pick_bucket(n, self.bucket_sizes)].append(int(idx))
        for bsize, idxs in buckets.items():
            for i in range(0, len(idxs), self.batch_size):
                chunk = idxs[i : i + self.batch_size]
                if len(chunk) < self.batch_size and self.drop_tail:
                    continue
                yield bsize, chunk

    def __iter__(self):
        for bsize, chunk in self._plan():
            graphs = [self.dataset[i] for i in chunk]
            indices = list(chunk)
            while len(graphs) < self.batch_size:
                graphs.append(_empty_graph(self.feat_dim, self.sidechain))
                indices.append(-1)
            batch = from_numpy_graphs(graphs[self.rows], max_nodes=bsize, device=self.device)
            yield (batch, np.asarray(indices)) if self.with_indices else batch


def inf_iterator(loader) -> Iterator:
    """Cycle over a loader's epochs forever."""
    while True:
        yield from loader
