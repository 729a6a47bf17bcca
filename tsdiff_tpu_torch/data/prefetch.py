"""Background batch prefetching for the streaming input pipeline.

Port of ``tsdiff_tpu/data/prefetch.py``: a worker thread packs the next
batches on the host and moves them to the card from pinned memory while the
card runs the current step; an exception in the worker is raised again in
the consumer.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import torch

from tsdiff_tpu_torch.core.graph import ReactionBatch


def to_device(batch: ReactionBatch, device) -> ReactionBatch:
    """``batch`` on ``device``; to a card through pinned memory, without
    blocking the host (the copy is ordered on the current stream)."""
    device = torch.device(device)
    if device.type != "cuda":
        return ReactionBatch(**{f.name: getattr(batch, f.name).to(device)
                                for f in dataclasses.fields(batch)})
    return ReactionBatch(**{f.name: getattr(batch, f.name).pin_memory().to(device, non_blocking=True)
                            for f in dataclasses.fields(batch)})


class Prefetcher:
    """Wrap a batch iterable; keep up to ``depth`` prepared items ahead.
    ``transfer`` maps each item inside the worker thread.  Closing the
    iterator (or dropping it) ends the worker after at most one more item."""

    _END = object()

    def __init__(self, iterable, depth: int = 2, transfer=None):
        self._iterable = iterable
        self._depth = depth
        self._transfer = transfer

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        err: list[BaseException] = []
        stop = threading.Event()   # set when the consumer closes or drops the iterator

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for item in self._iterable:
                    if self._transfer is not None:
                        item = self._transfer(item)
                    if not put(item):
                        return
            except BaseException as e:  # raised again in the consumer
                err.append(e)
            put(self._END)

        threading.Thread(target=worker, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is self._END:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()
