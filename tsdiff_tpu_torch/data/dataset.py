"""Datasets on disk and the shape buckets of padded batches.

The on-disk format is a pickle of plain-numpy graph dicts,
``{"format": "tsdiff_tpu.v1", "graphs": [...], "feat_dict": ...}``, or a bare
list of such dicts.  Graphs are padded to a small set of bucket sizes
(multiples of 8 atoms) and batches to a short ladder of row tiers, so a
sampling campaign sees only a few distinct shapes.

Reference PyG pickles are not read yet.
"""

from __future__ import annotations

import pickle
from typing import Sequence

FORMAT_TAG = "tsdiff_tpu.v1"


def save_dataset(path: str, graphs: list[dict], feat_dict=None, extra: dict | None = None):
    payload = {"format": FORMAT_TAG, "graphs": graphs, "feat_dict": feat_dict}
    if extra:
        payload.update(extra)
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_dataset(path: str) -> tuple[list[dict], dict | None]:
    """``(graphs, feat_dict)`` of a native ``tsdiff_tpu.v1`` pickle."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if isinstance(payload, dict) and payload.get("format") == FORMAT_TAG:
        return payload["graphs"], payload.get("feat_dict")
    if isinstance(payload, list) and payload and isinstance(payload[0], dict):
        return payload, None
    raise ValueError(
        f"{path}: not a {FORMAT_TAG} dataset (reference PyG pickles are not ported yet)"
    )


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
