"""What every cell of the benchmark shares: finding a cell's files by name,
the process's start, the card's name and power limit, the check that no JAX
module was loaded, and the result line.

Every cell is an entry of ``BENCHMARK.json``'s ``workloads``: a
configuration (``configs/<config>.json``), a traffic mix
(``traffic/<traffic>.json``, whose ``mode`` picks ``walk.py`` or ``train.py``) and the
limits of its correctness check (``limits/<workload>.json``).  Each per-layer
metric is a reader ``metrics/<name>.py``.  A later cell adds files; it edits
none of these.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: the build cache of the port's kernels and packer: fixed, inside the checkout
CACHE_DIR = os.path.join(HERE, ".cache")
#: top-level module names that no run may load (the JAX package, JAX itself)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tsdiff_tpu")

#: the published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W):
#: bf16 tensor-core flops and HBM bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def load_json(*parts: str) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_spec(workload: str) -> dict:
    """The workload's entry, its configuration, traffic mix, limits and the
    metrics that ``BENCHMARK.json`` gives it, found by name."""
    spec = benchmark_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]

    def applies(metric: dict) -> bool:
        return workload in metric.get("workloads", [workload])

    return dict(
        cell=cell,
        config=load_json("configs", f"{cell['config']}.json"),
        traffic=load_json("traffic", f"{cell['traffic']}.json"),
        limits=load_json("limits", f"{workload}.json"),
        end_to_end=[m for m in spec["end_to_end"] if applies(m)],
        per_layer=[m for m in spec["per_layer"] if applies(m)],
    )


def process_start() -> float:
    """``time.monotonic()`` of this process's start, from its start time in
    ``/proc/self/stat`` (clock ticks since boot) and the monotonic clock's
    reading of the time since boot."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])   # field 22, counted after the command's name
    age = time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
    return time.monotonic() - age


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that are the JAX package or JAX,
    compared whole (the part before the first dot), so that
    ``tsdiff_tpu_torch`` passes."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def require_no_jax(where: str) -> None:
    found = forbidden_modules()
    if found:
        print(f"JAX-free check failed {where}: sys.modules holds {found}", file=sys.stderr,
              flush=True)
        sys.exit(3)


def card() -> dict:
    """The card's name, power limit and clocks now, from ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return {}
    first = out.strip().splitlines()[0] if out.strip() else ""
    keys = ("name", "power_limit", "sm_clock", "sm_clock_max")
    return dict(zip(keys, (p.strip() for p in first.split(","))))


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown: dict | None = None) -> str:
    """The last line of a run's standard output.  ``checks`` (each number
    compared beside its limit) comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def print_checks(checks: dict) -> None:
    """Each number compared and its limit, as the last lines on stderr."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr, flush=True)
