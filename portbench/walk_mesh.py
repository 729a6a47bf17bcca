"""The sampling mode on a mesh of cards: ``walk.py``'s walk, with each
rank holding its block of the members on a ``(dp, ens)`` mesh of its own
card (the traffic's ``mesh``), as the sampling CLI runs on several GPUs:
``load_members(..., mesh=)``, ``make_ensemble(members, mesh)`` (the member
sum all-reduced over the ``ens`` group inside each captured step, on NCCL)
and ``WalkRunner(..., mesh=)`` (the NaN flag all-reduced, the answers
gathered onto every rank).

Rank 0 is the benchmark's own process (``run.py``): it sets up the cell,
starts the other ranks as processes of this module, decides every walk,
alone traces and checks, and prints the line.  Every walk rank 0 makes (its
rows, by the seed, shard and place that made them; its index; its clip;
whether it keeps the trajectory), and every read of a trajectory, which
gathers over the ranks, it sends first to the others over a Gloo group of
its own; they make the same call, and stop when told.  Their set-up walks
nothing of its own.

    python3 -m portbench.walk_mesh --spec <file> --seed <n> --rank <r> \
        --port <p> --device <cuda|cpu> [--control]

is one of the other ranks, as rank 0 starts it, ``<file>`` rank 0's cell
(its configuration, traffic and limits) as rank 0 holds it.  On the CPU
the ranks walk over Gloo, eagerly.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

from portbench import common, corpus
from portbench.walk import NUMBERS, Walk, WalkCell  # noqa: F401  (NUMBERS: calibrate.py)

#: the commands rank 0 sends: a walk's attempt, a trajectory's read, the end
RUN, TRAJ, STOP = 1, 2, 3
#: a command's length: op, seed, rows' seed, shard, place, index, retry, traj, bucket, tier
WIDTH = 10


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class MeshCell(WalkCell):
    def __init__(self, spec: dict, seed: int, device: str = "cuda", control: bool = False,
                 tracer=None, rank: int = 0, port: int | None = None):
        super().__init__(spec, seed, device, control, tracer if rank == 0 else None)
        self.rank, self.port, self.control = rank, port, control
        shape = self.traffic["mesh"]
        self.dp, self.ens = shape["dp"], shape["ens"]
        self.world = self.dp * self.ens
        self.procs: list[subprocess.Popen] = []
        self.keys: dict[int, tuple] = {}      # id(rows) -> (seed, shard, place), rank 0
        self.kept: list = []                  # the rows those ids belong to
        self.made: dict[tuple, list] = {}     # (seed, shard) -> batches, other ranks
        self.serving = False
        self.closed = False

    # -- the ranks ------------------------------------------------------------------------
    def setup(self) -> None:
        if self.rank == 0:
            self.port = free_port()
            self.spawn()
        self.join()
        super().setup()

    def spawn(self) -> None:
        os.makedirs(common.CACHE_DIR, exist_ok=True)
        spec = os.path.join(common.CACHE_DIR, f"mesh_spec_{self.port}.json")
        with open(spec, "w") as f:
            json.dump(self.spec, f)
        args = [sys.executable, "-m", "portbench.walk_mesh", "--spec", spec, "--seed",
                str(self.seed), "--port", str(self.port), "--device", self.device]
        for r in range(1, self.world):
            self.procs.append(subprocess.Popen(
                args + ["--rank", str(r)] + (["--control"] if self.control else []),
                cwd=common.ROOT, stdout=sys.stderr))

    def join(self) -> None:
        import torch.distributed as dist

        from tsdiff_tpu_torch.parallel import make_mesh
        from tsdiff_tpu_torch.parallel.multihost import initialize

        cuda = self.device == "cuda"
        initialize(f"localhost:{self.port}", self.world, self.rank, device=self.device,
                   backend="nccl" if cuda else "gloo")
        self.mesh = make_mesh(dp=self.dp, ens=self.ens)
        self.control_group = dist.new_group(backend="gloo")

    def _members(self, dev):
        import torch

        from tsdiff_tpu_torch.diffusion.ensemble import load_members, make_ensemble

        cfg = self.cfg
        dtype = torch.bfloat16 if cfg["dtype"] == "bfloat16" else torch.float32
        paths = [os.path.join(common.ROOT, p) for p in cfg["members"]]
        members, model_cfg = load_members(paths, dev, dtype,
                                          fused_score=cfg.get("fused_score", False),
                                          quant=self.path["quant"], mesh=self.mesh)
        self.mesh_ensemble = make_ensemble(members, self.mesh)
        return members, model_cfg

    def runner(self, n_pad: int, tier: int, clip: float, traj: bool = False):
        key = (n_pad, tier, clip, traj)
        if key not in self.runners:
            r = self.WalkRunner(self.mesh_ensemble, self.schedule, self.settings(clip, traj),
                                self.capture, self.pool, step_draws=True, mesh=self.mesh)
            if self.rank == 0:
                read = r.trajectory

                def trajectory(rows, _read=read, _key=key):
                    self.send(TRAJ, 0, (0, 0, 0), _key[2] != self.traffic["clip"], True,
                              _key[0], rows)
                    return _read(rows)
                r.trajectory = trajectory
            self.runners[key] = r
        return self.runners[key]

    # -- the commands ------------------------------------------------------------------------
    def send(self, op: int, index: int, rows_key: tuple, retry: bool, traj: bool, n_pad: int,
             tier: int) -> None:
        import torch
        import torch.distributed as dist

        seed, shard, place = rows_key
        cmd = torch.tensor([op, self.seed, seed, shard, place, index, int(retry), int(traj),
                            n_pad, tier], dtype=torch.int64)
        dist.broadcast(cmd, 0, group=self.control_group)

    def receive(self) -> list[int]:
        import torch
        import torch.distributed as dist

        cmd = torch.zeros(WIDTH, dtype=torch.int64)
        dist.broadcast(cmd, 0, group=self.control_group)
        return cmd.tolist()

    def batches(self, shard: int, graphs: list[dict]) -> list[Walk]:
        out = super().batches(shard, graphs)
        for place, w in enumerate(out):
            self.keys[id(w.rows)] = (self.seed, shard, place)
            self.kept.append(w.rows)
        return out

    def walk(self, w: Walk, index: int, traj: bool = False):
        if self.rank and not self.serving:
            return None          # the other ranks' set-up: rank 0 sends its walks
        return super().walk(w, index, traj)

    def attempt(self, w: Walk, clip: float, traj: bool = False):
        if self.rank == 0:
            self.send(RUN, w.index, self.keys[id(w.rows)], clip != self.traffic["clip"],
                      traj, w.n_pad, len(w.rows))
        return super().attempt(w, clip, traj)

    def rows_of(self, seed: int, shard: int, place: int) -> Walk:
        if (seed, shard) not in self.made:
            graphs = corpus.make_shard(self.traffic, seed, 10 ** 6 if shard == -1 else shard)
            self.made[(seed, shard)] = WalkCell.batches(self, shard, graphs)
        return self.made[(seed, shard)][place]

    def serve(self) -> None:
        """The other ranks' loop: each of rank 0's commands, until the end."""
        self.serving = True
        while True:
            op, seed, rseed, shard, place, index, retry, traj, n_pad, tier = self.receive()
            if op == STOP:
                return
            clip = 20.0 if retry else self.traffic["clip"]
            if op == TRAJ:
                self.runner(n_pad, tier, clip, True).trajectory(tier)
                continue
            self.seed = seed
            src = self.rows_of(rseed, shard, place)
            w = Walk(index=index, shard=shard, rows=src.rows, real=src.real, n_pad=src.n_pad)
            self.attempt(w, clip, bool(traj))

    def close(self) -> None:
        """Rank 0: tell the other ranks to stop and wait for them to exit
        (ending any that has not after a minute).  The NCCL world is left to
        the process's exit, as the other ranks leave theirs: its teardown
        is not waited on; a Gloo world (the CPU) is taken down here."""
        if self.rank or self.closed:
            return
        import torch.distributed as dist

        self.closed = True
        self.send(STOP, 0, (0, 0, 0), False, False, 0, 0)
        for r, p in enumerate(self.procs, start=1):
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                print(f"rank {r} did not exit after the end: ended", file=sys.stderr, flush=True)
                p.kill()
                p.wait()
        if self.mesh.backend == "gloo":
            dist.destroy_process_group()

    def check(self, memory_peak: int | None = None) -> dict:
        try:
            return super().check(memory_peak)
        finally:
            self.close()


Cell = MeshCell


def calibration_readings(spec: dict, seeds: list[int], control: bool) -> list[dict]:
    """``walk.calibration_readings`` on the mesh: the check's numbers, seed
    by seed, on the first shard of the traffic.  One mesh a process on the
    card (its NCCL world ends with the process): read the program's seeds
    and the control's in two processes."""
    out = []
    cell = MeshCell(spec, seeds[0], "cuda", control=control)
    cell.setup()
    try:
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
    finally:
        cell.close()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one of the other ranks of a mesh cell")
    p.add_argument("--spec", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    from portbench.run import cache_environment

    cache_environment()
    import torch
    import torch.distributed as dist

    from tsdiff_tpu_torch.utils.compile_cache import maybe_enable_compile_cache

    maybe_enable_compile_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(args.spec) as f:
        spec = json.load(f)
    cell = MeshCell(spec, args.seed, args.device, args.control, rank=args.rank, port=args.port)
    cell.setup()
    cell.serve()
    sys.stdout.flush()
    sys.stderr.flush()
    if cell.mesh.backend == "gloo":
        dist.destroy_process_group()
        return 0
    os._exit(0)     # the NCCL world's teardown is not waited on (``close``)


if __name__ == "__main__":
    sys.path[:0] = [common.ROOT]
    sys.exit(main())
