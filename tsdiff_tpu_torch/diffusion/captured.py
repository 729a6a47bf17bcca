"""The reverse walk of one (bucket, respacing, clip), replayed from one CUDA
graph of its step per batch tier.

The JAX service and sampling CLI compile the whole reverse diffusion once
per (bucket, tier, clip) and rerun the compiled program
(``tsdiff_tpu/serve.py``, ``tsdiff_tpu/cli/sampling.py:270-345``).  Here a
``WalkRunner`` holds, for each tier, the buffers a round reads and writes:
the batch's statics (``PackedEnsemble.prepare``/``DenseEnsemble.prepare``),
the positions, the round's noise ``(n_walk, tier, bucket, 3)``, the step
counter, the NaN flag and, with ``save_traj``, the trajectory ``(n_walk,
tier, bucket, 3)``, written at the counter inside the step.  What a step
computes is the runner's walk: the condensed model's ``DiffusionWalk`` by
default, or the dual encoder's ``dual_objective.DualWalk`` (its DDPM or
DSM walk, the JAX package's ``dual_dynamic_sampling`` and
``dsm_annealed_sampling``), each a table read at the counter; on a batch of
protein subgraphs the dual walk pins the backbone atoms to the batch's
coordinates at the start and after every step (``DualStatics.pin``), as the
JAX package's protein sampler does.  With
``capture`` it records the walk's step on those buffers in one CUDA graph,
after one eager warm-up step (which builds
the kernel library, sets the kernel's attributes and settles the
allocator), and a round replays the graph ``n_walk`` times; without it the
same step runs eagerly on the same buffers.  Every graph of a runner comes
from the memory pool its caller gives, so one service's graphs share one.

A round copies its batch's statics and start into the buffers, fills the
noise buffer from the caller's generator (or copies the caller's noise into
it), resets the counter and the flag, walks, and synchronises once, to read
the flag.  No random number is drawn inside a step: the round's noise is
drawn before it, so a captured and an eager round on the same noise are
equal bit for bit.  From a generator, the re-noising draw of
``noise_from_time_t`` comes first, then the step noise: one draw of the
whole round (the service), or with ``step_draws`` one draw of ``(tier,
bucket, 3)`` per step in step order, as ``dynamic_sampling`` draws it (the
sampling CLI, whose samples stay those of its eager loop).

On a mesh (``parallel/sharding.py``) a round's start and noise are drawn
for the global tier, identically on every rank, and each rank walks its own
rows of them (``batch_spec``) with its block of the members, so a ``dp=2``
run walks the rows of the one-rank run of the same seed.  The NaN flag is
an ``all_reduce(MAX)`` over the world, so a NaN on one rank sends every
rank to the clip-20 retry, and the final positions are gathered onto every
rank (``replicate_output``).  A step's collective (the member sum over
``ens``) is captured in the graph on NCCL; Gloo's collectives cannot be
captured, so on a Gloo mesh the caller walks eagerly (``capture=False``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from tsdiff_tpu_torch.diffusion.sampler import DiffusionWalk, SamplingSettings, at_counter
from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule


def can_capture(device, mesh=None) -> bool:
    """Whether a step can run as a CUDA graph: on CUDA, and not with a Gloo
    mesh, whose collectives cannot be captured (decided by the mesh's
    backend, ``dist.get_backend()``)."""
    return torch.device(device).type == "cuda" and (mesh is None or mesh.backend != "gloo")


def copy_into(dst, src) -> None:
    """Copy every tensor of ``src`` into the tensor at the same place in
    ``dst``: tensors, dataclasses, lists and tuples of them, and None where
    both hold None.  Shapes and dtypes must agree."""
    if isinstance(dst, torch.Tensor):
        if not isinstance(src, torch.Tensor) or src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(f"cannot copy {getattr(src, 'shape', src)} into a "
                             f"{dst.dtype} {tuple(dst.shape)} buffer")
        dst.copy_(src)
    elif dataclasses.is_dataclass(dst):
        for f in dataclasses.fields(dst):
            copy_into(getattr(dst, f.name), getattr(src, f.name))
    elif isinstance(dst, (list, tuple)):
        if len(dst) != len(src):
            raise ValueError(f"cannot copy {len(src)} items into {len(dst)}")
        for d, s in zip(dst, src):
            copy_into(d, s)
    elif dst is not None or src is not None:
        raise TypeError(f"cannot copy a {type(src).__name__} into a {type(dst).__name__}")


def _pin(statics) -> dict:
    """The protein-mode arguments of a dual walk's step (``DualStatics.pin``:
    the sidechain mask and the backbone's coordinates); none otherwise."""
    pin = getattr(statics, "pin", None)
    return pin() if pin is not None else {}


@dataclasses.dataclass
class _TierBuffers:
    statics: object             # the ensemble's statics, copied into each round
    step_fn: object             # the ensemble's step function on ``statics``
    pos: torch.Tensor           # (tier, bucket, 3) float32
    noise: torch.Tensor         # (n_walk, tier, bucket, 3) float32
    counter: torch.Tensor       # () int64
    nan_flag: torch.Tensor      # () bool
    traj: torch.Tensor | None   # (n_walk, tier, bucket, 3) float32 with save_traj
    graph: torch.cuda.CUDAGraph | None = None
    rounds: int = 0             # rounds walked at this tier


class WalkRunner:
    """The reverse walk of one (bucket, respacing, clip) of a service, for
    any batch tier; ``run`` is one round.  ``mesh``: this rank's rows of
    every tier, its block of the members in ``ensemble``.  ``walk``: the
    walk's table, start, update and final scale, by default the condensed
    model's ``DiffusionWalk(schedule, settings)``; the dual encoder's is a
    ``dual_objective.DualWalk``."""

    def __init__(self, ensemble, schedule: DiffusionSchedule, settings: SamplingSettings,
                 capture: bool, pool=None, step_draws: bool = False, mesh=None, walk=None):
        if capture and not can_capture("cuda", mesh):
            raise ValueError("Gloo collectives cannot be captured: walk with capture=False")
        self.ensemble = ensemble
        self.mesh = mesh
        self.schedule = schedule
        self.settings = settings
        self.capture = capture
        self.pool = pool
        self.step_draws = step_draws
        self.walk = walk if walk is not None else DiffusionWalk(schedule, settings)
        self.n_walk = self.walk.n_walk
        self.scale = self.walk.scale
        self._tables: tuple | None = None
        self._tiers: dict[int, _TierBuffers] = {}
        #: CUDA graphs recorded, one per tier at most
        self.captures = 0

    def rounds(self) -> dict[int, int]:
        """Rounds walked so far, by tier."""
        return {tier: buf.rounds for tier, buf in self._tiers.items()}

    def trajectory(self, tier: int) -> torch.Tensor:
        """The scaled-frame trajectory ``(n_walk, tier, bucket, 3)`` of the
        last round at ``tier`` (``save_traj``), step k's positions in row k;
        on a mesh every rank's rows (a collective)."""
        traj = self._tiers[tier].traj
        if self.mesh is None:
            return traj
        from tsdiff_tpu_torch.parallel.multihost import replicate_output

        return replicate_output(traj.transpose(0, 1).contiguous(), self.mesh).transpose(0, 1)

    def _rows(self, tier: int) -> slice | None:
        if self.mesh is None:
            return None
        from tsdiff_tpu_torch.parallel.sharding import batch_spec

        return batch_spec(self.mesh).slice(tier)

    def _draw_noise(self, buf: _TierBuffers, gen: torch.Generator, shape, rows) -> None:
        """Fill the noise buffer from ``gen``: ``shape`` is a step's global
        shape, of which this rank keeps ``rows``."""
        if rows is None:
            if self.step_draws:
                for step_noise in buf.noise:
                    step_noise.normal_(generator=gen)
            else:
                buf.noise.normal_(generator=gen)
        elif self.step_draws:
            for step_noise in buf.noise:
                step_noise.copy_(torch.randn(shape, generator=gen, device=buf.noise.device)[rows])
        else:
            buf.noise.copy_(torch.randn((self.n_walk, *shape), generator=gen,
                                        device=buf.noise.device)[:, rows])

    def _step(self, buf: _TierBuffers) -> None:
        step_noise = at_counter(buf.noise, buf.counter)
        pos = self.walk.step(buf.step_fn, buf.pos, buf.statics.node_mask, self._tables,
                             buf.counter, step_noise, buf.nan_flag, **_pin(buf.statics))
        buf.pos.copy_(pos)
        if buf.traj is not None:   # the counter has moved past this step
            buf.traj.index_copy_(0, buf.counter.view(1) - 1, pos[None])

    def _reset(self, buf: _TierBuffers, start: torch.Tensor) -> None:
        buf.pos.copy_(start)
        buf.counter.zero_()
        buf.nan_flag.zero_()

    def _record(self, buf: _TierBuffers, start: torch.Tensor) -> None:
        """One eager warm-up step on a side stream, then the round's start
        restored and the step recorded.  ``thread_local``: the service's
        worker thread captures while other threads of the process (the HTTP
        front, a caller waiting on its futures) may free CUDA tensors."""
        side = torch.cuda.Stream(device=buf.pos.device)
        side.wait_stream(torch.cuda.current_stream(buf.pos.device))
        with torch.cuda.stream(side):
            self._step(buf)
        torch.cuda.current_stream(buf.pos.device).wait_stream(side)
        self._reset(buf, start)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
            self._step(buf)
        buf.graph = graph
        self.captures += 1

    @torch.no_grad()
    def run(self, batch, pos_init: torch.Tensor,
            noise: torch.Tensor | torch.Generator) -> tuple[np.ndarray, bool]:
        """One round: ``pos_init`` (tier, bucket, 3) the unit-variance start;
        ``noise`` the step noise (n_walk, tier, bucket, 3), or the generator
        that draws ``noise_from_time_t``'s re-noising and then fills the
        round's noise buffer in place (as ``torch.randn`` of that shape would
        draw it, or of each step's shape in turn with ``step_draws``).
        Returns the final physical-frame positions as numpy and the NaN
        flag.  On a mesh ``pos_init`` and ``noise`` are the global tier's,
        ``batch`` this rank's rows of it, and every rank returns the whole
        tier's positions and the flag of any rank."""
        tier = pos_init.shape[0]
        noise_shape = (self.n_walk, *pos_init.shape)
        if isinstance(noise, torch.Tensor) and noise.shape != noise_shape:
            raise ValueError(f"noise must be {noise_shape}, got {tuple(noise.shape)}")
        rows = self._rows(tier)
        statics = self.ensemble.prepare(batch)
        buf = self._tiers.get(tier)
        if buf is None:
            dev = pos_init.device
            if self._tables is None:
                self._tables = self.walk.tables(dev)
            local = pos_init if rows is None else pos_init[rows]
            local_noise = (self.n_walk, *local.shape)
            buf = _TierBuffers(
                statics=statics, step_fn=self.ensemble.step_fn(statics),
                pos=torch.empty_like(local), noise=local.new_empty(local_noise),
                counter=torch.zeros((), dtype=torch.int64, device=dev),
                nan_flag=torch.zeros((), dtype=torch.bool, device=dev),
                traj=local.new_zeros(local_noise) if self.settings.save_traj else None,
            )
            self._tiers[tier] = buf
        else:
            copy_into(buf.statics, statics)
        mask = buf.statics.node_mask[..., None].to(pos_init.dtype)
        gen = None if isinstance(noise, torch.Tensor) else noise
        start = self.walk.start(pos_init, generator=gen)
        if rows is not None:
            start = start[rows]
        start = start * mask
        pin = _pin(buf.statics)
        if pin:
            start = torch.where(pin["sc3"], start, pin["pos_gt"])
        if gen is None:
            buf.noise.copy_(noise if rows is None else noise[:, rows])
        else:
            self._draw_noise(buf, gen, pos_init.shape, rows)
        self._reset(buf, start)
        if self.capture:
            if buf.graph is None:
                self._record(buf, start)
            for _ in range(self.n_walk):
                buf.graph.replay()
        else:
            for _ in range(self.n_walk):
                self._step(buf)
        buf.rounds += 1
        pos = buf.pos * self.scale
        if self.mesh is None:
            return pos.cpu().numpy(), bool(buf.nan_flag.item())
        from tsdiff_tpu_torch.parallel.multihost import replicate_output

        flag = buf.nan_flag.to(torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return replicate_output(pos, self.mesh).cpu().numpy(), bool(flag.item())
