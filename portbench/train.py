"""The training driver: one member of the condensed encoder trained as the
train CLI trains it with ``--packed_train --dtype bfloat16 --device_data
auto`` (``tsdiff_tpu_torch/cli/train.py``): the corpus resident on the card
(``DeviceResidentData``), the epoch's bucket schedule walked by the CLI's
``ResidentLoop``, each step the resident train step (``make_train_step``,
``make_resident_train_step``: the packed forward on torch ops, autograd,
the clip and Adam) replayed from the CUDA graph of its bucket
(``StepGraphs``), the learning rate a device tensor.  Validation and saves
are not run: they are outside what the window measures.

The benchmark makes the inputs: the corpus (``corpus.py``, a fixed set of
sizes, shuffled), the initial weights (drawn on the card from the seed), and
each step's timesteps and noise (drawn on the card from the seed and the
step's index, antithetic timesteps as the CLI draws them).

Set-up walks the first epoch, which records every bucket's graph (a
bucket's first step runs eagerly), puts the weights and Adam's state back
to their start in place, and takes three steps more, each a replay of its
bucket's graph through the window's own call.  Of these it keeps what the
check reads: the rows each step gathered, its draws and loss, the first
gradient as Adam holds it after one step (its first moment over ``1 -
b1``), and the weights after the third.  The window takes steps until
``--seconds`` have passed and waits for the last.  The check: the reference
takes the same three steps from the same weights on the same rows and
draws, in float32.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import corpus
from portbench.walk import _seed_int, _span, draw_weights


#: the numbers that a training cell's check compares, each against its limit
NUMBERS = ("loss_rel", "grad1_gap", "change3_gap", "rows_differing")


class TrainCell:
    def __init__(self, spec: dict, seed: int, device: str = "cuda", tracer=None):
        self.spec, self.seed, self.device = spec, seed, device
        self.cfg, self.traffic = spec["config"], spec["traffic"]
        self.tracer = tracer
        self.steps_done = 0
        self.records: list[dict] = []
        self.window_steps: list[tuple[int, int]] = []   # (bucket, real graphs) of each step

    def setup(self) -> None:
        import torch

        from tsdiff_tpu_torch.cli.train import ResidentLoop
        from tsdiff_tpu_torch.config import Config
        from tsdiff_tpu_torch.data.resident import DeviceResidentData, gather_batch
        from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
        from tsdiff_tpu_torch.models import get_model
        from tsdiff_tpu_torch.train.captured import StepGraphs
        from tsdiff_tpu_torch.train.trainer import (init_train_state, make_optimizer,
                                                    make_resident_train_step, make_train_step)

        self.torch = torch
        tr, cfg = self.traffic, self.cfg
        dev = torch.device(self.device)
        self.graphs = corpus.make_shard(tr, self.seed, 0)
        self.res = DeviceResidentData(self.graphs, tr["batch"], None,
                                      seed=_seed_int(self.seed, 5) % 2 ** 31, device=dev)
        self.loop = ResidentLoop(self.res, 1)
        from tsdiff_tpu_torch.data.dataset import pick_bucket

        self.sizes_by_bucket: dict[int, list[int]] = {}
        for g in self.graphs:
            n = len(g["atom_type"])
            self.sizes_by_bucket.setdefault(pick_bucket(n, self.res.bucket_sizes), []).append(n)
        model_cfg = Config(cfg["model"])
        dtype = torch.bfloat16 if cfg["dtype"] == "bfloat16" else torch.float32
        self.model = get_model(model_cfg, dtype=dtype).to(dev)
        self.w0 = draw_weights(self.model, _seed_int(self.seed, 1), dev)
        self.model.load_state_dict(self.w0)
        opt = Config(cfg["optimizer"])
        self.tx = make_optimizer(opt, cfg["max_grad_norm"])
        schedule = DiffusionSchedule.from_config(model_cfg)
        self.T = len(schedule.alphas)
        train_step = make_train_step(self.model, self.tx, schedule, t0=0, t1=self.T)
        self.res_step = make_resident_train_step(train_step, tr["batch"])
        self.state = init_train_state(self.model, self.tx)
        self.graphs_rec = StepGraphs(dev) if dev.type == "cuda" else None
        self.lr = torch.tensor(opt["lr"], dtype=torch.float32, device=dev)
        copies: dict[bytes, list[int]] = {}     # a graph's indices, by its coordinates and bonds
        for i, g in enumerate(self.graphs):
            copies.setdefault(self._key(np.asarray(g["pos"], np.float32),
                                        corpus.dense_bonds(g)), []).append(i)
        while self.loop.pos < len(self.loop.schedule):      # the first epoch
            self.step()
        self.restart()
        for k in range(3):
            rec = self.step(keep=True)
            batch = gather_batch(rec.pop("arrays"), rec.pop("plan"), rec.pop("cursor"),
                                 tr["batch"])
            rows = []
            for b in range(batch.pos.shape[0]):
                n = int(batch.node_mask[b].sum())
                if n:
                    left = copies.get(self._key(batch.pos[b, :n].cpu().numpy(),
                                                batch.bond_mat[b, :n, :n].cpu().numpy()), [])
                    rows.append(left.pop() if left else -1)     # -1: not found, or repeated
            rec["rows"] = rows
            rec["real_rows"] = [b for b in range(batch.pos.shape[0])
                                if bool(batch.node_mask[b].any())]
            if k == 0:
                b1 = self.cfg["optimizer"]["beta1"]
                rec["grad1"] = {n: (m / (1 - b1)).clone()
                                for n, m in self.state.opt_state["mu"].items()}
            self.records.append(rec)
        self.w3 = {k: v.detach().clone() for k, v in self.state.params.items()}
        self.sync()

    @staticmethod
    def _key(pos: np.ndarray, bonds: np.ndarray) -> bytes:
        """A graph's coordinates and bond codes: two reactions of the same
        atom types have the same chain, and differ in their bonds alone."""
        return pos.astype(np.float32).tobytes() + bonds.astype(np.int64).tobytes()

    def restart(self) -> None:
        """The weights back to ``w0`` and Adam's state to its start, in place,
        where the recorded graphs read and write them."""
        torch = self.torch
        opt = self.state.opt_state
        with torch.no_grad():
            for name, p in self.state.params.items():
                p.copy_(self.w0[name])
            for moments in (opt["mu"], opt["nu"]):
                for m in moments.values():
                    m.zero_()
            for counter in (opt["count"], self.state.step):
                if isinstance(counter, torch.Tensor):
                    counter.zero_()

    def draws(self, bucket: int, index: int):
        """The step's timesteps (antithetic pairs over the schedule) and
        noise, drawn on the card from the seed and the step's index."""
        torch = self.torch
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_seed_int(self.seed, 6, index))
        B = self.traffic["batch"]
        half = torch.randint(0, self.T, (B // 2 + 1,), generator=gen, device=self.device)
        t = torch.cat([half, self.T - 1 - half])[:B]
        noise = torch.randn((B, bucket, 3), generator=gen, device=self.device)
        return t, noise

    def step(self, keep: bool = False) -> dict | None:
        """One step as the CLI takes it; ``keep``: what the check reads."""
        with _span(self.tracer, "load"):
            bucket, arrays, plan, cursor, real = self.loop.next()
            t, noise = self.draws(bucket, self.steps_done)
        rec = None
        if keep:
            rec = dict(bucket=bucket, arrays=arrays, plan=plan.clone(),
                       cursor=int(cursor), t=t.clone(), noise=noise.clone())

        def fn(t, noise):
            return self.res_step(self.state, arrays, plan, cursor, self.lr, t=t, noise=noise)[1]
        with _span(self.tracer, "step"):
            if self.graphs_rec is None:
                metrics = fn(t, noise)
            else:
                metrics = self.graphs_rec(("train", bucket), fn, t, noise)
        self.steps_done += 1
        self.last = metrics
        if keep:
            rec["loss"] = float(metrics["loss"])
        self.window_steps.append((bucket, real))
        return rec

    def sync(self) -> None:
        if self.torch.device(self.device).type == "cuda":
            self.torch.cuda.synchronize()

    def window(self, seconds: float, trace_steps: int = 0) -> dict:
        self.window_steps = []
        first = self.steps_done
        if self.tracer is not None and trace_steps:
            self.tracer.start()
        t_start = time.monotonic()
        traced = 0
        while True:
            self.step()
            traced += 1
            if self.tracer is not None and trace_steps and traced == trace_steps:
                self.tracer.stop()
            if time.monotonic() - t_start >= seconds:
                break
        float(self.last["loss"])          # the last step's end
        t_end = time.monotonic()
        if self.tracer is not None and trace_steps and traced < trace_steps:
            self.tracer.stop()
        graphs = sum(real for _, real in self.window_steps)
        return dict(t_start=t_start, t_end=t_end, steps=self.steps_done - first,
                    traced_steps=min(traced, trace_steps), attempted=graphs, failed=0,
                    train_graphs_per_s=graphs / (t_end - t_start))

    def reference(self, matmul=None):
        import torch

        from portbench.reference.train import TrainReference

        cfg = self.cfg
        return TrainReference(cfg, cfg["optimizer"], cfg["max_grad_norm"],
                              cfg["optimizer"]["lr"], matmul or torch.matmul)

    def readings(self, ref) -> dict:
        """The check's numbers: each of the three steps' loss against the
        reference's (relative), and by the worst leaf the norms of the first
        gradient and of the weights' change after three steps."""
        torch = self.torch
        from portbench.reference.check import exact_float32
        from portbench.reference.condensed import from_torch_names, reference_name
        from portbench.reference.graphs import dense_batch

        rows_ok = all(r >= 0 for rec in self.records for r in rec["rows"])
        seen = [r for rec in self.records for r in rec["rows"]]
        distinct = rows_ok and len(set(seen)) == len(seen)
        with exact_float32():
            p = from_torch_names(self.w0)
            state = ref.init_state(p)
            losses, grad1 = [], None
            for k, rec in enumerate(self.records):
                graphs = [self.graphs[r] for r in rec["rows"]]
                sel = torch.tensor(rec["real_rows"], device=rec["t"].device)
                batch = dense_batch(graphs, rec["bucket"], self.device)
                loss, grads = ref.grads(p, batch, rec["t"][sel], rec["noise"][sel])
                losses.append(loss)
                if k == 0:
                    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
                    scale = 1.0 if norm < ref.max_norm else float(ref.max_norm / norm)
                    grad1 = {n: g * scale for n, g in grads.items()}
                p = ref.update(p, grads, state)
        def gap(prog: float, ref: float, floor: float) -> float:
            value = abs(prog - ref) / max(ref, floor, 1e-30)
            return value if np.isfinite(value) else float("inf")

        loss_rel = max(gap(rec["loss"], abs(lr), 0.0) for rec, lr in zip(self.records, losses))
        g_ref = {n: float(v.norm()) for n, v in grad1.items()}
        median = float(np.median(list(g_ref.values())))
        moved = {n for n, v in g_ref.items() if v >= 1e-3 * median}
        g_prog = {reference_name(n)[0]: float(v.norm()) for n, v in self.records[0]["grad1"].items()}
        grad_gaps = {n: gap(g_prog[n], g_ref[n], median) for n in g_ref}
        w0 = from_torch_names(self.w0)
        w3 = from_torch_names(self.w3)
        c_ref = {n: float((p[n] - w0[n]).norm()) for n in moved}
        c_prog = {n: float((w3[n] - w0[n]).norm()) for n in moved}
        c_median = float(np.median(list(c_ref.values()))) if c_ref else 0.0
        change_gaps = {n: gap(c_prog[n], c_ref[n], c_median) for n in moved}

        def worst(gaps: dict) -> list:
            return sorted(([n, v] for n, v in gaps.items()), key=lambda x: -x[1])[:3]
        return dict(loss_rel=float(loss_rel), grad1_gap=max(grad_gaps.values()),
                    change3_gap=max(change_gaps.values(), default=float("inf")),
                    rows_differing=0 if distinct else 1,
                    left_out=sorted(set(g_ref) - moved), losses=losses,
                    program_losses=[rec["loss"] for rec in self.records],
                    worst_grad1=worst(grad_gaps), worst_change3=worst(change_gaps),
                    grad_norm=[float(np.sqrt(sum(v ** 2 for v in g_ref.values()))),
                               float(np.sqrt(sum(v ** 2 for v in g_prog.values())))])

    def check(self, memory_peak: int | None = None) -> dict:
        r = self.readings(self.reference())
        lim = self.spec["limits"]
        return {name: {"value": r[name], "limit": lim[name], "ok": r[name] <= lim[name]}
                for name in NUMBERS}


Cell = TrainCell


def calibration_readings(spec: dict, seeds: list[int], control: bool) -> list[dict]:
    """The check's numbers, seed by seed, each from a set-up (which takes
    the three steps the check follows); ``control``: the reference with the
    products of ``reference/condensed.py``'s function that the traffic's
    ``control.reference_matmul`` names, in the precision below the
    configuration's, where the program has no such path of its own."""
    import gc
    import json

    import torch

    from portbench.reference import condensed

    matmul = None
    if control:
        matmul = getattr(condensed, spec["traffic"]["control"]["reference_matmul"])
    out = []
    for seed in seeds:
        t0 = time.monotonic()
        cell = TrainCell(spec, seed, "cuda")
        cell.setup()
        r = cell.readings(cell.reference(matmul))
        r.update(seed=seed, seconds=time.monotonic() - t0)
        out.append(r)
        print(json.dumps(r), flush=True)
        del cell
        gc.collect()
        torch.cuda.empty_cache()
    return out
