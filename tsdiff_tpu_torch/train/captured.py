"""The train and validation steps, each replayed from one CUDA graph per
(kind, bucket).

The JAX package runs each of its steps as one compiled program per batch
shape: the train step (``tsdiff_tpu/train/trainer.py:121-156``), the
resident train step with its batch cursor traced (``:159-176``), the
resident eval step (``:179-190``) and the eval step (``:193-205``).  Here a
``StepGraphs`` records a step in a CUDA graph at its first call for a key
and replays that graph at every later call; ``diffusion/captured.py`` is its
twin for the sampling step.

* What a step reads and writes beyond its inputs stays at fixed addresses
  (``train/trainer.py``): the parameters, the moments, the optimizer's count,
  the step counter, the EMA and the learning-rate tensor; the resident
  corpus, each bucket's plan buffer and device cursor.
* What changes between calls (the timesteps and noise, drawn before the step
  from the caller's generator in the eager step's order, and a streamed
  batch) is copied into the graph's own buffers on the current stream before
  the replay.  A replay therefore equals the eager step on the same draws
  bit for bit wherever the eager step equals itself.
* The first call of a key runs the step eagerly on a side stream: it is that
  call's step, and the warm-up that builds the kernel libraries, B3's
  weight-gradient schedule table (made from pinned memory on first use),
  the schedule's device table, autograd's and the allocator's state.  Then
  the graph is recorded; recording runs nothing.  Every operand and scratch
  buffer of the step is then at the address the graph holds, which the
  stack kernels' tensor maps, encoded on the host at recording, need.
* Recording uses ``capture_error_mode="thread_local"``: the prefetcher's
  worker thread pins batches and copies them to the card meanwhile.
* Every graph of one ``StepGraphs`` draws its memory from one pool.  A
  graph's outputs may then lie where a graph recorded before it keeps its
  intermediates, which a later replay of that graph overwrites; so a replay
  returns copies of its outputs, made on the stream right after it, and no
  output is read after another replay, whatever the order of the buckets.
* Wrapper counters (``.launches`` and the like) advance at the eager call
  and at recording, never on replay: a replay's kernels show under
  torch.profiler.
* While ``torch.profiler`` records, a call is one span of the step's part
  (``utils/profiling.py``): ``train.record`` (a key's first call, the eager
  step and the capture), or ``train.copy_in``, ``train.replay`` and
  ``train.copy_out`` (the output clones).
* On a data-parallel mesh (NCCL) the step's all-reduces (the loss's sums,
  the gradients) are recorded with it; their communicators exist before,
  made by ``parallel.sharding.Mesh``'s eager warm-up collective and by the
  key's eager first call.  A Gloo mesh's steps run eagerly (the train CLI
  makes no ``StepGraphs``): Gloo's collectives cannot be captured.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

from tsdiff_tpu_torch.diffusion.captured import copy_into
from tsdiff_tpu_torch.utils.misc import map_tree
from tsdiff_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class _Graph:
    inputs: tuple                 # the step's input buffers, copied into per call
    outputs: object               # the step's outputs, written by each replay
    graph: torch.cuda.CUDAGraph


class StepGraphs:
    """One CUDA graph per key, e.g. ``("train", bucket)``, of the step the
    caller gives with it; ``graphs(key, fn, *inputs)`` returns what
    ``fn(*inputs)`` returns (tensors in dicts, tuples, dataclasses)."""

    def __init__(self, device, pool=None):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"StepGraphs records CUDA graphs, not on {self.device}")
        self.pool = torch.cuda.graph_pool_handle() if pool is None else pool
        self._graphs: dict = {}
        #: replays by key; the first call of a key is eager and not counted
        self.replays: collections.Counter = collections.Counter()

    @property
    def recorded(self) -> list:
        """The keys with a graph, in the order recorded."""
        return list(self._graphs)

    def __call__(self, key, fn, *inputs):
        g = self._graphs.get(key)
        if g is not None:
            with span("train.copy_in"):
                copy_into(g.inputs, inputs)
            with span("train.replay"):
                g.graph.replay()
            self.replays[key] += 1
            with span("train.copy_out"):
                return map_tree(torch.clone, g.outputs)
        with span("train.record"):
            return self._record(key, fn, inputs)

    def _record(self, key, fn, inputs):
        """A key's first call: the step eagerly on a side stream, then its
        graph recorded; returns the eager step's outputs."""
        buffers = map_tree(torch.clone, inputs)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = fn(*buffers)
        current.wait_stream(side)
        # the caller reads these on the current stream: keep their memory
        # from side-stream reuse until it has
        map_tree(lambda t: t.record_stream(current), out)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
            outputs = fn(*buffers)
        self._graphs[key] = _Graph(buffers, outputs, graph)
        return out
