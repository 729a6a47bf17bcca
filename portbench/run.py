"""Run one cell of the benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up the cell (its configuration, traffic and limits found by name from
``BENCHMARK.json``), warms up every shape the cell's traffic uses, measures
for ``--seconds``, checks what the measured window produced against the
plain reference, and prints one JSON line last: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from a profiled stretch of the window.  Exits non-zero without a result
where there is no card, and where a module of JAX or of the JAX package was
loaded.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE)]

from portbench import common  # noqa: E402

def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_environment() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.makedirs(common.CACHE_DIR, exist_ok=True)
    os.environ["TSDIFF_COMPILE_CACHE"] = common.CACHE_DIR
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(common.CACHE_DIR, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(common.CACHE_DIR, "triton")


def driver(mode: str):
    """The cell class of the traffic's ``mode``: ``Cell`` of ``<mode>.py``
    beside this file, found by name, so that a new mode is a new file."""
    return importlib.import_module(f"portbench.{mode}").Cell


def read_metric(name: str, ctx: dict):
    """The reader ``metrics/<name>.py``'s value, or None where it finds
    nothing to read."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def main(argv=None) -> int:
    t_process = common.process_start()
    args = parse_args(argv)
    cache_environment()
    spec = common.cell_spec(args.workload)
    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from tsdiff_tpu_torch.utils.compile_cache import maybe_enable_compile_cache

    maybe_enable_compile_cache()
    line = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", t_process)
    print(line, flush=True)
    return 0


def run_cell(spec: dict, seed: int, seconds: float, traced: bool, device: str,
             t_process: float) -> str:
    """Set up, measure and check one run of the cell on ``device``; returns
    the result line, after the numbers compared on stderr."""
    import torch

    from portbench.trace import Tracer, breakdown, busy_seconds

    cuda = device == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tracer = Tracer()
    cell = driver(spec["traffic"]["mode"])(spec, seed, device, tracer=tracer if cuda else None)
    cell.setup()
    common.require_no_jax("after set-up")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.monotonic() - t_process
    win = cell.window(seconds, spec["traffic"]["trace"]["count"] if traced and cuda else 0)
    memory_peak = 0
    if cuda:
        torch.cuda.synchronize()
        memory_peak = torch.cuda.max_memory_allocated()
    checks = cell.check(memory_peak)
    common.require_no_jax("after the window")

    chips = spec["cell"]["chips"]
    ctx = dict(spec=spec, cell=cell, window=win, setup_s=setup_s, trace=None)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu", "count": chips,
           "memory_peak_bytes": int(memory_peak)}
    bd = None
    if traced and cuda:
        ctx["trace"] = tracer.summary()
        dev["busy_s"] = busy_seconds(ctx["trace"]["kernels"])
        dev["window_s"] = ctx["trace"]["window_s"]
        bd = breakdown(ctx["trace"])
    metrics = {}
    for m in spec["per_layer"] if traced else spec["end_to_end"]:
        value = read_metric(m["name"], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    print(f"card: {common.card() if cuda else 'none'}; setup_s {setup_s}; window "
          f"{win['t_end'] - win['t_start']} s; walks retried at clip 20: "
          f"{win.get('retried', 0)}", file=sys.stderr)
    correct = all(c["ok"] for c in checks.values())
    common.print_checks(checks)
    return common.result_line(correct, win["attempted"], win["failed"], metrics, dev,
                              checks, bd)


if __name__ == "__main__":
    sys.exit(main())
