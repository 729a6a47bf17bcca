"""Batching inference service for TS generation, on PyTorch and CUDA.

A resident process keeps the ensemble's weights on the card and serves
requests in fixed-shape batches:

  * :class:`SamplerService` — a thread-safe request batcher around the
    ensemble sampler: requests queue up, a worker groups them by size bucket
    and quality tier, pads each group to a fixed batch tier (max_batch, /2,
    /4, ...), runs the reverse diffusion, and resolves per-request futures.
    Each (bucket, tier, respacing) walks by replaying one CUDA graph of the
    sampling step, recorded once per service lifetime
    (``diffusion/captured.py``); ``capture=False`` runs the same step eagerly
    (the CPU, and comparisons on the card).
  * ``python -m tsdiff_tpu_torch.serve CKPT... --port 8000`` — a minimal
    stdlib HTTP front end: ``POST /generate`` with JSON graphs returns
    generated coordinates; ``GET /healthz`` liveness.  The routes, JSON keys
    and status codes are those of ``python -m tsdiff_tpu.serve``; ``/healthz``
    adds ``nan_rounds``, the rounds whose NaN flag was set.

Graphs use the standard dict layout (data/dataset.py): ``atom_type (n,)``,
``r_feat``/``p_feat`` ``(n, F)``, ``edge_index (2, E)`` + ``edge_type (E,)``
(or dense ``bond_mat``), all JSON arrays over HTTP.

Each round draws its start and its step noise from a ``torch.Generator``
seeded with ``seed * 7919 + served``, as the JAX service derives its key;
JAX's random stream itself cannot be reproduced in torch, so the two services
give different samples of the same distribution.  Runs on CUDA unless
``device="cpu"`` (``--device cpu``) is given.

Several GPUs (``mesh``, ``--mesh DP,ENS --multihost``): one process (rank)
per GPU on a ``(dp, ens)`` mesh (``parallel/``).  Rank 0 runs the HTTP
front and the batcher; every round it broadcasts a header ``(command,
bucket, tier, served, respacing)`` and the packed batch, and the other
ranks follow in ``worker_loop``.  Each rank walks its rows of the tier with
its block of the members; the start and the noise of a round are drawn for
the whole tier from the round's seed on every rank, the NaN flag and the
positions gathered over the ranks, so every rank records its graph of a
(bucket, tier, respacing) in the same round and the collectives line up.
On a Gloo mesh (``--dist_backend gloo``, or the CPU) the walk runs eagerly:
Gloo's collectives cannot be captured.  A shutdown header releases the
workers.
"""

from __future__ import annotations

import dataclasses
import functools
import queue
import sys
import threading
import time
from concurrent.futures import Future

import numpy as np

RETRY_CLIP = 20.0


class ServiceOverloaded(RuntimeError):
    """Raised by ``submit`` when the bounded request queue is full
    (backpressure: the caller should retry later or shed load)."""


@dataclasses.dataclass
class _Request:
    graph: dict
    future: Future
    n_atoms: int
    deadline: float | None = None  # time.monotonic() cutoff, None = no limit
    respacing: int | None = None   # draft tier: strided step count (None = full)


class SamplerService:
    """Resident ensemble sampler with request batching.

    One worker thread owns the card: it alone runs CUDA work, the callers'
    threads touch numpy only.  ``submit`` is thread-safe and returns a
    ``concurrent.futures.Future`` resolving to
    ``{"pos_gen": (n, 3) float32, "nan": bool}``.
    """

    def __init__(
        self,
        ckpt_paths: list[str],
        n_steps: int = 5000,
        sampling_type: str = "ld",
        step_lr: float = 1e-7,
        clip: float = 1000.0,
        dtype: str = "bfloat16",
        fused_score: bool = False,
        quant: str | None = None,
        use_ema: bool = False,
        max_batch: int = 32,
        max_wait_s: float = 0.05,
        seed: int = 2022,
        max_pending: int | None = None,
        default_timeout_s: float | None = None,
        draft_respacing: int | None = None,
        device: str = "cuda",
        capture: bool = True,
        mesh=None,
    ):
        """``max_pending``: bound on queued (not-yet-running) requests; a full
        queue makes ``submit`` raise :class:`ServiceOverloaded`
        (backpressure).  Default ``4 * max_batch``; pass 0 for unbounded.

        ``default_timeout_s``: server-side deadline applied to every request
        that doesn't pass its own ``timeout_s``; expired requests are failed
        with ``TimeoutError`` instead of occupying a batch slot.

        ``draft_respacing``: step count of the fast-draft quality tier —
        requests submitted with ``quality="draft"`` run a respaced
        ``draft_respacing``-step walk of the same ``n_steps`` window.  Draft
        and full requests batch separately (different walks).

        ``quant``: ``"int8"`` runs the packed score's pair-row products in
        int8 (needs ``fused_score``).

        ``device``: ``"cuda"`` (default; raises without a card) or ``"cpu"``.
        ``capture``: walk by replaying a CUDA graph of the step (CUDA only);
        ``False`` runs the same step eagerly.

        ``mesh``: a ``parallel.Mesh`` of the ranks — the batch rows split
        over ``dp``, the members over ``ens`` (``dp`` must divide
        ``max_batch`` and the tier ladder, ``ens`` the checkpoints); the
        service runs on the mesh's device.  Every rank constructs the
        service alike; rank 0 serves requests, the others call
        ``worker_loop``."""
        import torch

        from tsdiff_tpu_torch.diffusion.captured import can_capture
        from tsdiff_tpu_torch.diffusion.ensemble import load_members, make_ensemble
        from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
        from tsdiff_tpu_torch.parallel import multihost
        from tsdiff_tpu_torch.utils.misc import get_logger, resolve_device

        if quant is not None and not fused_score:
            raise ValueError("quant requires fused_score")
        self.device = resolve_device(device)
        if capture and self.device.type != "cuda":
            raise ValueError("capture records CUDA graphs: pass capture=False on the CPU")
        self.mesh = mesh
        self._dp = 1
        self._nproc = multihost.process_count()
        self._is_coord = multihost.is_coordinator()
        if self._nproc > 1 and mesh is None:
            raise ValueError(
                "multi-process serving requires a mesh spanning all ranks (e.g. "
                "SamplerService(..., mesh=make_mesh(dp=D, ens=E)); the CLI flag is --mesh D,E)"
            )
        if mesh is not None:
            self._dp = mesh.dp
            if len(ckpt_paths) % mesh.ens:
                raise ValueError(
                    f"{len(ckpt_paths)} ensemble members not divisible by ens={mesh.ens}")
            if max_batch % self._dp:
                raise ValueError(f"max_batch {max_batch} not divisible by dp={self._dp}")
            self.device = mesh.device
            if capture and not can_capture(self.device, mesh):
                get_logger("serve").info(
                    "Gloo collectives cannot be captured in a CUDA graph: rounds walk eagerly")
                capture = False
        if draft_respacing is not None and not (1 <= draft_respacing <= n_steps):
            raise ValueError(
                f"draft_respacing={draft_respacing} must be in [1, n_steps={n_steps}]"
            )
        members, model_cfg = load_members(
            ckpt_paths, self.device, torch.bfloat16 if dtype == "bfloat16" else torch.float32,
            fused_score=fused_score, quant=quant, use_ema=use_ema, mesh=mesh,
        )
        if model_cfg.network != "condensenc":
            # the JAX service builds its batches with the condensed model's
            # features and walks its score: a dual encoder is not served
            raise NotImplementedError(
                f"the service serves condensed-encoder members, not {model_cfg.network}")
        self.ensemble = make_ensemble(members, mesh)
        self.schedule = DiffusionSchedule.from_config(model_cfg)
        self._feat_dim = int(model_cfg.feat_dim)
        self.n_steps = n_steps
        self.sampling_type = sampling_type
        self.step_lr = step_lr
        self.clip = clip
        self.draft_respacing = draft_respacing
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.seed = seed
        self.default_timeout_s = default_timeout_s
        self.capture = capture
        # one memory pool for every graph: the worker replays them one at a time
        self._pool = torch.cuda.graph_pool_handle() if capture else None
        self._gen = torch.Generator(device=self.device)
        # (bucket, respacing) or (bucket, respacing, "retry") -> WalkRunner
        self._runners: dict[tuple, object] = {}
        if max_pending is None:
            max_pending = 4 * max_batch
        self._q: queue.Queue[_Request | None] = queue.Queue(maxsize=max_pending)
        self._served = 0
        self._timed_out = 0
        self._cancelled = 0
        self._rejected = 0
        self._closed = False
        # serializes the closed-check+enqueue in submit() against close()
        # setting _closed, so no request can land behind the shutdown
        # sentinel (its future would never resolve)
        self._submit_lock = threading.Lock()
        self._worker = None
        if self._is_coord:
            # the other ranks never batch requests: they follow rank 0's
            # broadcasts in worker_loop() instead
            self._worker = threading.Thread(target=self._loop, daemon=True)
            self._worker.start()

    @property
    def _graphs_captured(self) -> int:
        """CUDA graphs recorded so far: one per (bucket, tier, respacing),
        and one per retried (bucket, tier, respacing)."""
        return sum(r.captures for r in list(self._runners.values()))

    # -- client API ---------------------------------------------------------

    def submit(
        self,
        graph: dict,
        timeout_s: float | None = None,
        quality: str = "full",
    ) -> Future:
        """Enqueue one graph; returns a Future resolving to
        ``{"pos_gen", "nan"}``.

        Raises :class:`ServiceOverloaded` when the bounded queue is full.
        ``timeout_s`` sets a server-side deadline (fails with ``TimeoutError``
        if the request hasn't STARTED by then); cancel an unstarted request
        with ``future.cancel()`` — it then never occupies a batch slot.

        ``quality``: ``"full"`` (every diffusion step) or ``"draft"`` (the
        respaced fast tier; requires the service to be constructed with
        ``draft_respacing``)."""
        if quality not in ("full", "draft"):
            raise ValueError(f"quality must be 'full' or 'draft', got {quality!r}")
        respacing = None
        if quality == "draft":
            if self.draft_respacing is None:
                raise ValueError(
                    "draft-quality request but the service has no draft tier "
                    "(pass draft_respacing=... / --draft_respacing)"
                )
            respacing = self.draft_respacing
        fut: Future = Future()
        n = int(np.asarray(graph["atom_type"]).shape[0])
        if timeout_s is None:
            timeout_s = self.default_timeout_s
        deadline = time.monotonic() + timeout_s if timeout_s is not None else None
        req = _Request(graph=graph, future=fut, n_atoms=n, deadline=deadline,
                       respacing=respacing)
        if not self._is_coord:
            raise RuntimeError(
                "submit() on a worker rank — only rank 0 accepts requests; this "
                "process should run worker_loop()"
            )
        # validate the shape contract here, failing only this request: a
        # malformed graph reaching the batcher would desync the broadcast
        # against the workers' placeholders
        for feat in ("r_feat", "p_feat"):
            width = int(np.asarray(graph[feat]).shape[-1])
            if width != self._feat_dim:
                raise ValueError(
                    f"{feat} width {width} != model feat_dim {self._feat_dim}"
                )
        if n < 1:
            raise ValueError("empty graph")
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("service closed")
            try:
                self._q.put_nowait(req)
            except queue.Full:
                self._rejected += 1
                raise ServiceOverloaded(
                    f"request queue full ({self._q.maxsize} pending)"
                ) from None
        return fut

    def generate(
        self,
        graphs: list[dict],
        timeout_s: float | None = None,
        quality: str = "full",
    ) -> list[dict]:
        """Blocking convenience: submit all, wait for all.  All-or-nothing:
        if the queue fills mid-submit the already-queued part is cancelled."""
        futs: list[Future] = []
        try:
            for g in graphs:
                futs.append(self.submit(g, timeout_s=timeout_s, quality=quality))
        except ServiceOverloaded:
            for f in futs:
                f.cancel()
            raise
        return [f.result() for f in futs]

    def close(self, drain: bool = True):
        """Stop the worker.  ``drain=True`` (default) serves every request
        already queued before returning; ``drain=False`` cancels them."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
        # past this point no submit() can enqueue (closed-check is under the
        # same lock), so the flush and sentinel below see the final queue
        if not drain:
            try:
                while True:
                    req = self._q.get_nowait()
                    if req is not None and req.future.cancel():
                        self._cancelled += 1
            except queue.Empty:
                pass
        self._q.put(None)
        if self._worker is not None:
            self._worker.join(timeout=600)

    # -- worker -------------------------------------------------------------

    def _collect(self) -> list[_Request] | None:
        """One blocking item, then drain up to max_batch within the window."""
        first = self._q.get()
        if first is None:
            return None
        reqs = [first]
        try:
            while len(reqs) < self.max_batch:
                item = self._q.get(timeout=self.max_wait_s)
                if item is None:
                    self._q.put(None)  # re-queue shutdown for the main loop
                    break
                reqs.append(item)
        except queue.Empty:
            pass
        return reqs

    def _loop(self):
        from tsdiff_tpu_torch.data.dataset import default_buckets, pick_bucket

        while True:
            reqs = self._collect()
            if reqs is None:
                if self._nproc > 1:
                    # release the worker ranks out of worker_loop()
                    self._broadcast_header(1, 0, 0, 0, 0)
                return
            # group key: (bucket, respacing) — draft- and full-quality
            # requests walk different step counts, so they batch apart
            groups: dict[tuple[int, int], list[_Request]] = {}
            buckets = default_buckets(max(r.n_atoms for r in reqs))
            for r in reqs:
                k = (pick_bucket(r.n_atoms, buckets), r.respacing or 0)
                groups.setdefault(k, []).append(r)
            for (bucket, respacing), group in sorted(groups.items()):
                # shed expired / client-cancelled requests before planning
                # tiers; set_running_or_notify_cancel makes surviving
                # requests uncancellable from here on
                now = time.monotonic()
                live = []
                for r in group:
                    # cancellation check FIRST: set_exception on a future the
                    # client already cancelled raises InvalidStateError and
                    # would kill the worker thread
                    if not r.future.set_running_or_notify_cancel():
                        self._cancelled += 1
                    elif r.deadline is not None and now > r.deadline:
                        self._timed_out += 1
                        r.future.set_exception(
                            TimeoutError("request deadline expired in queue")
                        )
                    else:
                        live.append(r)
                i = 0
                for tier in self._plan_tiers(len(live)):
                    chunk = live[i : i + tier]
                    i += tier
                    try:
                        self._run_group(bucket, chunk, tier, respacing)
                    except Exception as e:  # noqa: BLE001 - propagate to callers
                        for r in chunk:
                            if not r.future.done():
                                r.future.set_exception(e)

    def _tier_ladder(self) -> list[int]:
        """Descending batch tiers (``data/dataset.py::tier_ladder``)."""
        from tsdiff_tpu_torch.data.dataset import tier_ladder

        return tier_ladder(self.max_batch, self._dp)

    def _plan_tiers(self, n: int) -> list[int]:
        """Tier sizes whose chunks cover ``n`` requests, minimizing padded
        slots with a small per-extra-chunk penalty (each dispatch has a
        fixed per-step floor).  One graph per (bucket, tier, respacing).
        E.g. max_batch=100: n=54 -> [50, 6]; n=5 -> [6]."""
        if n == 0:
            return []
        ladder = self._tier_ladder()
        chunk_penalty = max(4, self._dp)

        @functools.lru_cache(maxsize=None)
        def best(m: int) -> tuple[float, tuple[int, ...]]:
            if m == 0:
                return 0.0, ()
            cands = []
            fit = min((t for t in ladder if t >= m), default=None)
            if fit is not None:
                cands.append((float(fit), (fit,)))
            for t in ladder:
                if t <= m:
                    cost, plan = best(m - t)
                    cands.append((t + chunk_penalty + cost, (t,) + plan))
            return min(cands)

        plan: list[int] = []
        while n > self.max_batch:
            plan.append(self.max_batch)
            n -= self.max_batch
        plan.extend(sorted(best(n)[1], reverse=True))
        return plan

    def _batch_tier(self, n: int) -> int:
        """Smallest single tier holding ``n`` requests (the worker uses
        :meth:`_plan_tiers`)."""
        tier = self.max_batch
        for t in self._tier_ladder():
            if t >= n:
                tier = t
        return tier

    def _run_group(self, bucket: int, group: list[_Request], tier: int, respacing: int = 0):
        from tsdiff_tpu_torch.core.graph import from_numpy_graphs

        # fixed (tier, bucket) shape: pad with copies of the last graph so
        # each (bucket, tier, respacing) is recorded once per service lifetime
        graphs = [r.graph for r in group]
        gpad = graphs + [graphs[-1]] * (tier - len(graphs))
        batch = from_numpy_graphs(gpad, max_nodes=bucket, device=self.device)
        if self._nproc > 1:
            # the workers mirror this round from the broadcasts: the header,
            # then the batch; the start and noise derive from ``served``
            self._broadcast_header(0, bucket, tier, self._served, respacing)
            self._broadcast_batch(batch)
        pos, nan = self._execute(bucket, tier, batch, respacing)
        self._served += len(group)
        for b, r in enumerate(group):
            r.future.set_result(
                {"pos_gen": pos[b, : r.n_atoms].astype(np.float32), "nan": nan}
            )

    def _runner(self, key: tuple):
        """The walk of ``key`` = (bucket, respacing[, "retry"]), made at
        first use; the retry walks at clip 20."""
        runner = self._runners.get(key)
        if runner is None:
            from tsdiff_tpu_torch.diffusion.captured import WalkRunner
            from tsdiff_tpu_torch.diffusion.sampler import SamplingSettings

            settings = SamplingSettings(
                sampling_type=self.sampling_type,
                n_steps=self.n_steps,
                step_lr=self.step_lr,
                clip=RETRY_CLIP if key[2:] == ("retry",) else self.clip,
                timestep_respacing=key[1] or None,
            )
            runner = WalkRunner(self.ensemble, self.schedule, settings, self.capture,
                                self._pool, mesh=self.mesh)
            self._runners[key] = runner
        return runner

    def _execute(self, bucket: int, tier: int, batch, respacing: int = 0):
        """Device side of one round, the same on every rank (the NaN retry
        reads a flag reduced over the ranks, so all take it or none).
        Returns ``(pos (tier, bucket, 3) np, nan bool)``.  The start and the
        step noise are drawn before the walk from the service's generator,
        seeded per round; on a mesh this rank walks its rows of ``batch``."""
        import torch

        if self.mesh is not None:
            from tsdiff_tpu_torch.parallel.multihost import make_global_batch

            batch = make_global_batch(batch, self.mesh)
        self._gen.manual_seed(self.seed * 7919 + self._served)
        pos_init = torch.randn((tier, bucket, 3), generator=self._gen, device=self.device)
        pos, nan = self._runner((bucket, respacing)).run(batch, pos_init, self._gen)
        if nan and self.clip > RETRY_CLIP:
            # same policy as the sampling CLI: one retry at clip 20
            retry = self._runner((bucket, respacing, "retry"))
            pos, nan = retry.run(batch, pos_init, self._gen)
        return pos, nan

    def _broadcast_header(self, cmd: int, bucket: int, tier: int, served: int,
                          respacing: int) -> None:
        import torch
        import torch.distributed as dist

        dist.broadcast(torch.tensor([cmd, bucket, tier, served, respacing], device=self.device),
                       src=0)

    @staticmethod
    def _broadcast_batch(batch) -> None:
        """Rank 0's batch into every rank's ``batch`` (a collective)."""
        import torch
        import torch.distributed as dist

        for f in dataclasses.fields(batch):
            t = getattr(batch, f.name)
            if t is None:
                continue
            dist.broadcast(t.view(torch.uint8) if t.dtype == torch.bool else t, src=0)

    def _placeholder_batch(self, bucket: int, tier: int):
        """A (tier, bucket) batch of zeros in the dtypes of
        ``from_numpy_graphs``, on the device: what a worker rank receives
        rank 0's batch into."""
        import torch

        from tsdiff_tpu_torch.core.graph import ReactionBatch

        def zeros(*shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        return ReactionBatch(
            atom_type=zeros(tier, bucket, dtype=torch.int64),
            r_feat=zeros(tier, bucket, self._feat_dim, dtype=torch.uint8),
            p_feat=zeros(tier, bucket, self._feat_dim, dtype=torch.uint8),
            pos=zeros(tier, bucket, 3, dtype=torch.float32),
            bond_mat=zeros(tier, bucket, bucket, dtype=torch.int64),
            node_mask=zeros(tier, bucket, dtype=torch.bool),
        )

    def worker_loop(self) -> None:
        """The entry point of every rank but 0 in multi-process serving:
        follow rank 0's broadcasts (one header and one batch per round) and
        run the same round, until the shutdown header arrives."""
        import torch
        import torch.distributed as dist

        if self._is_coord:
            raise RuntimeError("worker_loop() is for the ranks other than 0")
        if self._nproc == 1:
            raise RuntimeError("worker_loop() needs a multi-process mesh")
        placeholders: dict[tuple[int, int], object] = {}
        header = torch.zeros(5, dtype=torch.int64, device=self.device)
        while True:
            dist.broadcast(header, src=0)
            cmd, bucket, tier, served, respacing = header.tolist()
            if cmd == 1:
                return
            batch = placeholders.get((bucket, tier))
            if batch is None:
                batch = placeholders[(bucket, tier)] = self._placeholder_batch(bucket, tier)
            self._broadcast_batch(batch)
            self._served = served  # the round's seed derives from it
            try:
                self._execute(bucket, tier, batch, respacing)
            except Exception as e:  # noqa: BLE001
                # the round failed after both broadcasts, on every rank alike:
                # rank 0 fails its requests and serves on, and so does this
                # rank, instead of leaving the broadcasts unanswered
                print(f"worker round failed (contained): {e!r}", file=sys.stderr)


# -- HTTP front end ---------------------------------------------------------


def graph_from_json(d: dict) -> dict:
    """A request's JSON graph as the numpy graph dict ``submit`` takes."""
    g = {
        "atom_type": np.asarray(d["atom_type"], np.int32),
        "r_feat": np.asarray(d["r_feat"], np.float32),
        "p_feat": np.asarray(d["p_feat"], np.float32),
        "pos": np.asarray(d["pos"], np.float32) if d.get("pos") is not None else None,
    }
    if "bond_mat" in d:
        g["bond_mat"] = np.asarray(d["bond_mat"], np.int32)
    else:
        g["edge_index"] = np.asarray(d["edge_index"], np.int32)
        g["edge_type"] = np.asarray(d["edge_type"], np.int32)
    return g


def make_http_server(service: SamplerService, host: str, port: int):
    """A ``ThreadingHTTPServer`` on (host, port) in front of ``service``:
    ``POST /generate`` (200, 400 malformed, 503 overloaded, 504 deadline)
    and ``GET /healthz``.  Its handler threads touch numpy only.  The caller
    runs ``serve_forever`` and, to stop, ``shutdown`` and ``server_close``."""
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {
                    "ok": True, "served": service._served,
                    "pending": service._q.qsize(),
                    "timed_out": service._timed_out,
                    "cancelled": service._cancelled,
                    "rejected": service._rejected,
                    "nan_rounds": sum(r.nan_rounds for r in list(service._runners.values())),
                })
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                graphs = [graph_from_json(d) for d in req["graphs"]]
                results = service.generate(
                    graphs, timeout_s=req.get("timeout_s"),
                    quality=req.get("quality", "full"),
                )
                self._json(200, {
                    "pos_gen": [r["pos_gen"].tolist() for r in results],
                    "nan": [r["nan"] for r in results],
                })
            except ServiceOverloaded as e:
                self._json(503, {"error": f"overloaded: {e}"})
            except TimeoutError as e:
                self._json(504, {"error": f"timeout: {e}"})
            except Exception as e:  # noqa: BLE001 - report to client
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)


def parse_args(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("ckpt", type=str, nargs="+")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--n_steps", type=int, default=5000)
    parser.add_argument("--sampling_type", type=str, default="ld")
    parser.add_argument("--step_lr", type=float, default=1e-7)
    parser.add_argument("--clip", type=float, default=1000.0)
    parser.add_argument("--dtype", type=str, default="bfloat16")
    parser.add_argument("--fused_score", action="store_true", default=False)
    parser.add_argument("--use_ema", action="store_true", default=False)
    parser.add_argument("--max_batch", type=int, default=32)
    parser.add_argument("--max_wait_ms", type=float, default=50.0)
    parser.add_argument("--max_pending", type=int, default=None,
                        help="bounded queue size (default 4*max_batch; 0 = unbounded)")
    parser.add_argument("--timeout_s", type=float, default=None,
                        help="server-side default request deadline")
    parser.add_argument("--draft_respacing", type=int, default=None,
                        help="step count of the fast-draft quality tier "
                             "(respaced subsequence of the n_steps window); "
                             "requests opt in with quality='draft'")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default: CUDA graphs of the step) or cpu (eager)")
    parser.add_argument("--mesh", type=str, default="none",
                        help="DP,ENS mesh of ranks (e.g. '2,4'), or 'none'")
    parser.add_argument("--multihost", action="store_true", default=False,
                        help="multi-process serving, one rank per GPU: rank 0 runs the HTTP "
                             "server and the batcher, the others follow its broadcasts "
                             "(worker_loop). Pass --coordinator/--nprocs/--procid, or omit all "
                             "three under torchrun")
    parser.add_argument("--coordinator", type=str, default=None, help="host:port of rank 0")
    parser.add_argument("--nprocs", type=int, default=None, help="number of ranks")
    parser.add_argument("--procid", type=int, default=None, help="this process's rank")
    parser.add_argument("--dist_backend", type=str, default=None, choices=["nccl", "gloo"],
                        help="collectives' backend (default: nccl on cuda, gloo on cpu; gloo "
                             "walks eagerly)")
    parser.add_argument("--compile_cache", type=str, default=None,
                        help="directory that keeps the compiled kernels and packer between "
                             "processes (or set TSDIFF_COMPILE_CACHE; default "
                             "tsdiff_tpu_torch/_build/); CUDA graphs are recorded anew by "
                             "each process")
    args = parser.parse_args(argv)
    from tsdiff_tpu_torch.parallel.multihost import launched_by_torchrun

    distributed = args.multihost or launched_by_torchrun()
    if args.multihost and args.mesh == "none":
        raise SystemExit(
            "--multihost requires --mesh DP,ENS spanning all ranks "
            "(e.g. --mesh 8,1 for eight GPUs)"
        )
    if args.mesh != "none" and not distributed:
        dp, _, ens = args.mesh.partition(",")
        raise SystemExit(f"--mesh {args.mesh} needs {int(dp) * int(ens or 1)} ranks, one per "
                         "device: start them under torchrun, or each with --multihost "
                         "--coordinator/--nprocs/--procid")
    cluster = [f"--{k}" for k in ("coordinator", "nprocs", "procid")
               if getattr(args, k) is not None]
    if cluster and not args.multihost:
        raise SystemExit(f"{', '.join(cluster)} name a cluster: pass them with --multihost "
                         "and --mesh DP,ENS")
    return args


def main(argv=None):
    from tsdiff_tpu_torch.utils.compile_cache import maybe_enable_compile_cache

    args = parse_args(argv)
    maybe_enable_compile_cache(args.compile_cache)
    device = args.device
    mesh = None
    if args.mesh != "none":
        from tsdiff_tpu_torch.parallel import make_mesh, multihost

        device = multihost.initialize(args.coordinator, args.nprocs, args.procid,
                                      device=device, backend=args.dist_backend)
        dp, _, ens = args.mesh.partition(",")
        mesh = make_mesh(dp=int(dp), ens=int(ens) if ens else 1, device=device)
    service = SamplerService(
        args.ckpt, n_steps=args.n_steps, sampling_type=args.sampling_type,
        step_lr=args.step_lr, clip=args.clip, dtype=args.dtype,
        fused_score=args.fused_score, use_ema=args.use_ema,
        max_batch=args.max_batch, max_wait_s=args.max_wait_ms / 1e3,
        max_pending=args.max_pending, default_timeout_s=args.timeout_s,
        draft_respacing=args.draft_respacing, device=device,
        capture=args.device != "cpu", mesh=mesh,
    )
    if not service._is_coord:
        # a worker rank: no HTTP, follow rank 0's broadcasts until it shuts down
        service.worker_loop()
        return
    httpd = make_http_server(service, args.host, args.port)
    print(f"tsdiff_tpu_torch sampler serving on http://{args.host}:{args.port} "
          f"(POST /generate, GET /healthz)")
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        service.close()


if __name__ == "__main__":
    main()
