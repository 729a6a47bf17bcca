"""Faults planted under the timed path, to show that a cell's check comes out
false for each fault the cell can have (``tests/test_portbench_faults.py``
on the CPU; ``calibrate.py`` reads what they give on the card):

* ``unchanged_state``: a step that returns its state unchanged (a walk's
  positions; a train step's weights, Adam's moments still moving);
* ``half_batch``: half of the batch left out, the mean taken over the rest
  (a walk's second half of the graphs gets the first half's mean score; a
  train step's loss is the mean over the first half's atoms);
* ``altered_answer``: an answer altered where it is produced (one
  coordinate of a walk's first sample moved by 1e-3; a train step's update
  of one leaf, the edge features' first matrix, 10 % too large).

``timed_runner_altered``, a sampling cell's own, alters the answer of the
runners that the window times alone (those that keep no trajectory), as a
fault of the timed graph alone would: the check walks again by runners that
keep the trajectory, and has to see that their answers differ.

No cell spans chips, so an exchange between chips has no fault here.
"""

from __future__ import annotations

import contextlib
import dataclasses
from unittest import mock

import torch

NAMES = ("unchanged_state", "half_batch", "altered_answer")
WALK_NAMES = ("timed_runner_altered",)


@contextlib.contextmanager
def plant(name: str):
    from tsdiff_tpu_torch.diffusion import ensemble
    from tsdiff_tpu_torch.diffusion.captured import WalkRunner
    from tsdiff_tpu_torch.diffusion.dual_objective import DualWalk
    from tsdiff_tpu_torch.diffusion.sampler import DiffusionWalk
    from tsdiff_tpu_torch.train import trainer

    patches = []
    if name == "unchanged_state":
        for cls in (DiffusionWalk, DualWalk):
            def frozen(self, score_fn, pos, *args, _step=cls.step, **kw):
                _step(self, score_fn, pos, *args, **kw)      # the counter still moves
                return pos
            patches.append(mock.patch.object(cls, "step", frozen))

        def no_update(self, grads, opt_state, params, _update=trainer.Adam.update):
            updates, opt_state, norm = _update(self, grads, opt_state, params)
            return {k: torch.zeros_like(u) for k, u in updates.items()}, opt_state, norm
        patches.append(mock.patch.object(trainer.Adam, "update", no_update))
    elif name == "half_batch":
        for cls in (ensemble.PackedEnsemble, ensemble.DualEnsemble):
            def halved(self, statics, _step_fn=cls.step_fn):
                fn = _step_fn(self, statics)

                def wrapped(pos, *args, **kw):
                    out = fn(pos, *args, **kw)
                    half = out.shape[0] // 2
                    mean = out[:half].mean(0, keepdim=True)
                    return torch.cat([out[:half], mean.expand(out.shape[0] - half,
                                                              *out.shape[1:])])
                wrapped.returns_node_eq = getattr(fn, "returns_node_eq", False)
                return wrapped
            patches.append(mock.patch.object(cls, "step_fn", halved))

        def first_half(model, schedule, batch, *args, _loss=trainer.diffusion_loss, **kw):
            half = batch.node_mask.clone()
            half[batch.node_mask.shape[0] // 2:] = False
            return _loss(model, schedule, dataclasses.replace(batch, node_mask=half), *args, **kw)
        patches.append(mock.patch.object(trainer, "diffusion_loss", first_half))
    elif name == "altered_answer":
        def altered(self, *args, _run=WalkRunner.run, **kw):
            pos, nan = _run(self, *args, **kw)
            pos = pos.copy()
            pos[0, 0, 0] += 1e-3
            return pos, nan
        patches.append(mock.patch.object(WalkRunner, "run", altered))

        def altered_update(self, grads, opt_state, params, _update=trainer.Adam.update):
            updates, opt_state, norm = _update(self, grads, opt_state, params)
            leaf = "edge_cat.lin0.weight"
            if leaf in updates:
                updates[leaf] = updates[leaf] * 1.1
            return updates, opt_state, norm
        patches.append(mock.patch.object(trainer.Adam, "update", altered_update))
    elif name == "timed_runner_altered":
        def timed_altered(self, *args, _run=WalkRunner.run, **kw):
            pos, nan = _run(self, *args, **kw)
            if not self.settings.save_traj:
                pos = pos.copy()
                pos[0, 0, 0] += 1e-3
            return pos, nan
        patches.append(mock.patch.object(WalkRunner, "run", timed_altered))
    else:
        raise ValueError(f"unknown fault {name!r}")
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        yield
