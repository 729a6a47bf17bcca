"""The sampling driver: an ensemble's reverse walks, back to back, as the
sampling CLI runs them (``tsdiff_tpu_torch/cli/sampling.py``): members
loaded by ``ensemble.load_members`` (or built and given the configuration's
committed weights), the ensemble of ``make_ensemble``, each batch packed by
``from_numpy_graphs`` and walked by the ``WalkRunner`` of its (bucket, tier,
clip), one CUDA graph of the step replayed per step.  A walk flagged NaN is
walked again at clip 20, as the CLI does.

The traffic's graphs come in shards of a fixed set of sizes (``corpus.py``),
each sorted by size as ``--sort_by_size`` sorts a test set, cut into
batches of ``batch`` rows (``repeat`` rows per graph); every bucket and tier
the shards use is walked once while setting up.  The window walks the
shards' batches in order until ``--seconds`` have passed; the shard under
way then is finished, and the window ends with it.

The benchmark draws each walk's start and step noise itself, from the seed
and the walk's index, and hands them to the runner; the check after the
window draws them again.  The check (``readings``): walks of the window
drawn from the seed (the largest bucket among them) are walked once more,
as the window walked them, by runners that keep the trajectory; their
attempts and answers must equal the window's bit for bit, and their last
positions the trajectory's.  The reference, in float32, takes the
trajectory's positions before each of a few steps drawn from the seed and
makes the update: the gap to the program's next positions, over the
update's score part, is compared graph by graph.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from portbench import corpus
from portbench.common import ROOT


@dataclasses.dataclass
class Walk:
    index: int
    shard: int
    rows: list            # graphs, ``repeat`` times each, padded to the tier
    real: int             # rows that are not padding
    n_pad: int
    attempts: int = 0
    nan: bool = False     # still flagged NaN after the retry at clip 20
    steps: int = 0        # walk steps taken, both attempts counted
    pos: np.ndarray | None = None
    t_end: float = 0.0


def _seed_int(*parts: int) -> int:
    return int(np.random.SeedSequence([int(p) for p in parts]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


#: the numbers that a sampling cell's check compares, each against its limit
NUMBERS = ("step_rel_err", "answers_differing")


class WalkCell:
    """One sampling cell on ``device``; ``control`` runs the program's path in
    the precision below the configuration's, as the traffic's ``control``
    sets it (``quant``, ``tf32``; ``calibrate.py``)."""

    def __init__(self, spec: dict, seed: int, device: str = "cuda", control: bool = False,
                 tracer=None):
        self.spec, self.seed, self.device = spec, seed, device
        self.cfg, self.traffic = spec["config"], spec["traffic"]
        #: the program's settings: the traffic's, with its ``control`` over them
        self.path = {"quant": self.traffic.get("quant", "none"),
                     **(self.traffic.get("control", {}) if control else {})}
        self.tracer = tracer
        self.walks: list[Walk] = []
        self.pack_s: list[float] = []       # host seconds of each batch's packing

    # -- set-up -------------------------------------------------------------------
    def setup(self) -> None:
        import torch

        from tsdiff_tpu_torch.data.dataset import default_buckets
        from tsdiff_tpu_torch.diffusion.captured import WalkRunner, can_capture
        from tsdiff_tpu_torch.diffusion.ensemble import make_ensemble
        from tsdiff_tpu_torch.diffusion.sampler import SamplingSettings
        from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule

        self.torch = torch
        self.WalkRunner = WalkRunner
        dev = torch.device(self.device)
        tr = self.traffic
        if self.path.get("tf32", False):
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        self.members, self.model_cfg = self._members(dev)
        self.ensemble = make_ensemble(self.members)
        self.n_members = len(self.members)
        self.schedule = DiffusionSchedule.from_config(self.model_cfg)
        self.settings = lambda clip, traj=False: SamplingSettings(
            sampling_type=tr["sampling_type"], n_steps=tr["n_steps"], step_lr=tr["step_lr"],
            clip=clip, timestep_respacing=tr["respacing"], save_traj=traj)
        self.capture = can_capture(dev)
        self.pool = torch.cuda.graph_pool_handle() if self.capture else None
        self.runners: dict = {}
        self.buckets = default_buckets(tr["sizes"]["max"])
        self.shards = [self.batches(s, corpus.make_shard(tr, self.seed, s))
                       for s in range(tr["shards"])]
        warm = self.batches(-1, corpus.make_shard(tr, self.seed, 10 ** 6))
        seen = set()
        for w in warm:      # every (bucket, tier) once: kernels built, graphs recorded
            if (w.n_pad, len(w.rows)) not in seen:
                seen.add((w.n_pad, len(w.rows)))
                self.walk(w, -1 - len(seen))
        self.sync()

    def _members(self, dev):
        import torch

        from tsdiff_tpu_torch.config import Config
        from tsdiff_tpu_torch.diffusion.ensemble import load_members
        from tsdiff_tpu_torch.models import get_model

        cfg = self.cfg
        dtype = torch.bfloat16 if cfg["dtype"] == "bfloat16" else torch.float32
        if "members" in cfg:
            paths = [os.path.join(ROOT, p) for p in cfg["members"][: self.traffic.get("members")]]
            return load_members(paths, dev, dtype, fused_score=cfg.get("fused_score", False),
                                quant=self.path["quant"])
        model_cfg = Config(cfg["model"])
        model = get_model(model_cfg, dtype=dtype).to(dev).eval()
        self.weights = torch.load(os.path.join(ROOT, cfg["weights"]), map_location=dev,
                                  weights_only=True)
        model.load_state_dict(self.weights)
        return [model], model_cfg

    def batches(self, shard: int, graphs: list[dict]) -> list[Walk]:
        from tsdiff_tpu_torch.data.dataset import pick_bucket

        tr = self.traffic
        rows = [g for g in graphs for _ in range(tr.get("repeat", 1))]
        out = []
        for lo in range(0, len(rows), tr["batch"]):
            chunk = rows[lo: lo + tr["batch"]]
            real = len(chunk)
            chunk = chunk + [chunk[-1]] * (tr["batch"] - real)
            n_pad = max(pick_bucket(len(g["atom_type"]), self.buckets) for g in chunk)
            out.append(Walk(index=-1, shard=shard, rows=chunk, real=real, n_pad=n_pad))
        return out

    # -- one walk -------------------------------------------------------------------
    def runner(self, n_pad: int, tier: int, clip: float, traj: bool = False):
        key = (n_pad, tier, clip, traj)
        if key not in self.runners:
            settings = self.settings(clip, traj)
            walk = None
            if self.model_cfg.get("network") == "dualenc":
                from tsdiff_tpu_torch.diffusion.dual_objective import DualWalk

                walk = DualWalk.diffusion(self.schedule, settings)
            self.runners[key] = self.WalkRunner(self.ensemble, self.schedule, settings,
                                                self.capture, self.pool, step_draws=True,
                                                walk=walk)
        return self.runners[key]

    def inputs(self, w: Walk, n_walk: int):
        """The walk's unit-variance start (tier, bucket, 3) and step noise
        (n_walk, tier, bucket, 3), drawn on the device from the seed and the
        walk's index."""
        torch = self.torch
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_seed_int(self.seed, 2, w.index + 1000))
        shape = (len(w.rows), w.n_pad, 3)
        pos_init = torch.randn(shape, generator=gen, device=self.device)
        noise = torch.randn((n_walk, *shape), generator=gen, device=self.device)
        return pos_init, noise

    def walk(self, w: Walk, index: int, traj: bool = False):
        """Walk ``w`` as the CLI does: pack, draw, walk, and at clip 20 once
        more where the walk flagged NaN; returns the last attempt's runner.
        ``traj``: by runners that keep the trajectory."""
        w.index = index
        for attempt, clip in enumerate((self.traffic["clip"], 20.0)):
            runner, pos, nan = self.attempt(w, clip, traj)
            w.attempts = attempt + 1
            if not nan:
                break
        w.pos, w.nan = pos, nan
        return runner

    def attempt(self, w: Walk, clip: float, traj: bool = False):
        """One walk of ``w`` at ``clip``: ``(runner, positions, NaN flag)``;
        ``traj``: by a runner that keeps the trajectory."""
        from tsdiff_tpu_torch.core.graph import from_numpy_graphs

        tracer = self.tracer
        with _span(tracer, "pack"):
            t0 = time.monotonic()
            batch = from_numpy_graphs(w.rows, max_nodes=w.n_pad, device=self.device)
            self.pack_s.append(time.monotonic() - t0)
        runner = self.runner(w.n_pad, len(w.rows), clip, traj)
        with _span(tracer, "draw"):
            pos_init, noise = self.inputs(w, runner.n_walk)
        with _span(tracer, "walk"):
            pos, nan = runner.run(batch, pos_init, noise)
        w.steps += runner.n_walk
        return runner, pos, nan

    def sync(self) -> None:
        if self.torch.device(self.device).type == "cuda":
            self.torch.cuda.synchronize()

    # -- the window -------------------------------------------------------------------
    def window(self, seconds: float, trace_walks: int = 0) -> dict:
        """Walks back to back until ``seconds`` have passed and the shard
        under way is done: whole shards, so that every window walks the
        traffic's own mix of buckets, wherever the time runs out.  The first
        ``trace_walks`` under the tracer, started before the window opens."""
        self.pack_s = []
        order = [w for shard in self.shards for w in shard]
        per_shard = len(self.shards[0])
        if self.tracer is not None and trace_walks:
            self.tracer.start()
        t_start = time.monotonic()
        i = 0
        traced = []
        while True:
            src = order[i % len(order)]
            w = Walk(index=i, shard=src.shard, rows=src.rows, real=src.real, n_pad=src.n_pad)
            self.walk(w, i)
            w.t_end = time.monotonic()
            self.walks.append(w)
            if self.tracer is not None and i + 1 == trace_walks:
                self.tracer.stop()
                traced = list(self.walks)
            i += 1
            if w.t_end - t_start >= seconds and i % per_shard == 0:
                break
        if self.tracer is not None and trace_walks and i < trace_walks:
            self.tracer.stop()
            traced = list(self.walks)
        samples = sum(w.real for w in self.walks)
        return dict(t_start=t_start, t_end=self.walks[-1].t_end, attempted=samples,
                    pack_s=list(self.pack_s),
                    failed=sum(w.real for w in self.walks if w.nan),
                    retried=sum(w.attempts > 1 for w in self.walks),
                    walks=len(self.walks), traced=traced,
                    samples_per_s=samples / (self.walks[-1].t_end - t_start))

    # -- the check -------------------------------------------------------------------
    def check_walks(self) -> list[Walk]:
        """Walks of the window to check, drawn from the seed among those not
        flagged NaN (a failure, counted as such): one of the largest bucket
        and ``check.walks - 1`` others."""
        rng = np.random.default_rng(_seed_int(self.seed, 3))
        n = self.traffic["check"]["walks"]
        done = [w for w in self.walks if not w.nan]
        if not done:
            return []
        top = max(w.n_pad for w in done)
        largest = [w for w in done if w.n_pad == top]
        pick = [largest[rng.integers(len(largest))]]
        rest = [w for w in done if w is not pick[0]]
        for j in rng.permutation(len(rest))[: n - 1]:
            pick.append(rest[j])
        return pick

    def readings(self, reference) -> dict:
        """The check's numbers on the walks of ``check_walks``:

        * ``answers_differing``: answers of the window that a walk by runners
          that keep the trajectory does not give again bit for bit (a
          different number of attempts counts once), and that walk's answers
          that are not its trajectory's last positions in the physical frame
          (the reference's scale);
        * ``step_rel_err``: over steps drawn from the seed, the largest
          per-graph gap between the trajectory's step and the reference's
          step from the trajectory's positions before it, over the norm of
          the reference step's score part."""
        checks = self.traffic["check"]
        rel, differing, per_step = [], 0, []
        for w in self.check_walks():
            kept = Walk(index=w.index, shard=w.shard, rows=w.rows, real=w.real, n_pad=w.n_pad)
            runner = self.walk(kept, w.index, traj=True)
            differing += int(kept.attempts != w.attempts or kept.nan) + sum(
                not np.array_equal(kept.pos[b], w.pos[b]) for b in range(w.real))
            traj = runner.trajectory(len(w.rows)).float()
            final = (traj[-1] * reference.walk.scale).cpu().numpy()
            differing += sum(not np.array_equal(kept.pos[b], final[b]) for b in range(w.real))
            pos_init, noise = self.inputs(w, runner.n_walk)
            steps = reference.steps_to_check(self.seed, w.index, checks["steps"])
            gaps = reference.step_gaps(w.rows, w.n_pad, pos_init, noise, traj, steps, w.real)
            gaps = np.where(np.isfinite(gaps), gaps, np.inf)
            rel.append(gaps)
            per_step.append(dict(steps=steps, worst=gaps.max(axis=1).tolist(),
                                 p90=np.quantile(gaps, 0.9, axis=1).tolist(),
                                 median=np.median(gaps, axis=1).tolist()))
        return dict(step_rel_err=float(max(g.max() for g in rel)) if rel else float("inf"),
                    answers_differing=differing, per_step=per_step)

    def reference(self):
        from portbench.reference.check import WalkReference

        if "members" in self.cfg:
            members = [os.path.join(ROOT, p)
                       for p in self.cfg["members"][: self.traffic.get("members")]]
        else:
            members = self.weights
        return WalkReference(self.cfg, self.traffic, members, self.device)

    def check(self, memory_peak: int | None = None) -> dict:
        """Each number compared, its limit and whether it holds."""
        r = self.readings(self.reference())
        lim = self.spec["limits"]
        return {name: {"value": r[name], "limit": lim[name], "ok": r[name] <= lim[name]}
                for name in NUMBERS}


Cell = WalkCell


def calibration_readings(spec: dict, seeds: list[int], control: bool) -> list[dict]:
    """The check's numbers, seed by seed, on the first shard of the traffic
    (every bucket of the mix, at the cell's batch), walked as a window walks
    it; one cell for all seeds, since the weights do not depend on the seed."""
    import json

    out = []
    cell = WalkCell(spec, seeds[0], "cuda", control=control)
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


def _span(tracer, name):
    import contextlib

    return tracer.span(name) if tracer is not None else contextlib.nullcontext()


def draw_weights(model, seed: int, device) -> dict:
    """Weights for every parameter of ``model``, drawn on ``device`` from
    ``seed`` in two calls: embedding tables (names with ``emb``) N(0, 1);
    every other tensor U(-1/sqrt(fan_in), 1/sqrt(fan_in)), its fan-in the
    input width (a torch ``weight``'s last axis, a stacked (L, in, out)
    matrix's middle one, a vector's own length)."""
    import torch

    names = sorted(k for k, _ in model.named_parameters())
    shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
    normal = [k for k in names if "emb" in k]
    uniform = [k for k in names if k not in normal]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n_u = sum(int(np.prod(shapes[k])) for k in uniform)
    n_n = sum(int(np.prod(shapes[k])) for k in normal)
    u = torch.rand(n_u, generator=gen, device=device) * 2 - 1
    g = torch.randn(n_n, generator=gen, device=device)
    out, lo = {}, 0
    for k in uniform:
        shape = shapes[k]
        fan_in = shape[-1] if len(shape) == 2 else shape[1] if len(shape) == 3 else shape[0]
        n = int(np.prod(shape))
        out[k] = (u[lo: lo + n] / np.sqrt(fan_in)).view(shape)
        lo += n
    lo = 0
    for k in normal:
        n = int(np.prod(shapes[k]))
        out[k] = g[lo: lo + n].view(shapes[k])
        lo += n
    return out
