"""The sampling mode of the condensed network with the DimeNet++ encoder:
``walk.py``'s campaign walk (members built from the configuration and given
its committed weights, ``make_ensemble``'s ``DenseEnsemble``, one CUDA graph
of the step per (bucket, tier, clip)), with the check's reference
``reference/dimenetpp.py``, which computes the network over explicit
triplet lists.

The check's control (``calibrate.py``) is the reference with float8
products (the traffic's ``control``: ``reference_matmul``), the precision
below the configuration's bfloat16, as the training cell's is: the program
has no path below bfloat16.

While a run is traced, each walk keeps the counters of its batch that the
program's ensemble made in ``prepare`` (``DenseStatics.counts``: atoms,
pairs and triplets, real and computed), read after the walk from the
runner's statics; ``mfu.dimenet`` counts the work from them.
"""

from __future__ import annotations

import json
import time

from portbench import corpus
from portbench.walk import NUMBERS, Walk, WalkCell  # noqa: F401  (NUMBERS: calibrate.py)


class DimeNetCell(WalkCell):
    def reference(self):
        from portbench.reference import condensed
        from portbench.reference.dimenetpp import DimeNetWalkReference

        matmul = self.path.get("reference_matmul")
        return DimeNetWalkReference(self.cfg, self.traffic, [self.weights], self.device,
                                    *([getattr(condensed, matmul)] if matmul else []))

    def attempt(self, w: Walk, clip: float, traj: bool = False):
        runner, pos, nan = super().attempt(w, clip, traj)
        statics = getattr(runner, "statics", None)
        if self.tracer is not None and statics is not None:
            counts = getattr(statics(len(w.rows)), "counts", None)
            if counts is not None:
                w.counts = [int(c) for c in counts.tolist()]
        return runner, pos, nan


Cell = DimeNetCell


def calibration_readings(spec: dict, seeds: list[int], control: bool) -> list[dict]:
    """``walk.calibration_readings`` for this cell: the check's numbers,
    seed by seed, on the first shard of the traffic."""
    out = []
    cell = DimeNetCell(spec, seeds[0], "cuda", control=control)
    cell.setup()
    for seed in seeds:
        t0 = time.monotonic()
        cell.seed, cell.walks = seed, []
        shard = cell.batches(0, corpus.make_shard(spec["traffic"], seed, 0))
        for i, src in enumerate(shard):
            w = Walk(index=i, shard=0, rows=src.rows, real=src.real, n_pad=src.n_pad)
            cell.walk(w, i)
            cell.walks.append(w)
        r = cell.readings(cell.reference())
        r.update(seed=seed, seconds=time.monotonic() - t0,
                 attempts=[w.attempts for w in cell.walks])
        out.append(r)
        print(json.dumps(r), flush=True)
    return out
