"""Readings that the limits of the cells' checks are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 \
        [--faults 3]

For each seed the program runs as far as a run's check needs, and the check
reads its numbers as a run reads them: a sampling cell walks the first shard
of its traffic (every bucket of the mix, at the cell's batch); a training
cell sets up, which takes the three steps the check follows.  Then the
control does the same on the first seeds: the program's path in the
precision below the configuration's (the int8 score kernel for a bf16
ensemble; TF32 for a float32 model) or, where the program has none (bf16
training), the reference computed with float8 products.  With ``--faults``
each planted fault of ``faults.py`` too.  One JSON line per reading; the
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE)]

from portbench import common, faults  # noqa: E402
from portbench.run import cache_environment  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--faults", type=int, default=0, help="seeds for each planted fault")
    p.add_argument("--first-seed", type=int, default=4_000_000_000)
    p.add_argument("--steps", type=int, default=None, help="steps checked per walk")
    p.add_argument("--min-b", type=float, default=None, help="the least score part checked")
    args = p.parse_args(argv)
    cache_environment()
    from tsdiff_tpu_torch.utils.compile_cache import maybe_enable_compile_cache

    maybe_enable_compile_cache()
    spec = common.cell_spec(args.workload)
    mode = spec["traffic"]["mode"]
    if "check" in spec["traffic"]:
        spec["traffic"]["check"].update({k: v for k, v in (("steps", args.steps),
                                                            ("min_b", args.min_b))
                                         if v is not None})
    driver = importlib.import_module(f"portbench.{mode}")
    read, numbers = driver.calibration_readings, driver.NUMBERS
    seeds = [args.first_seed + i for i in range(max(args.seeds, args.control_seeds, args.faults))]
    summary = {"workload": args.workload, "card": common.card()}
    prog = read(spec, seeds[: args.seeds], control=False)
    summary["lower"] = {n: max(r[n] for r in prog) for n in numbers}
    ctrl = read(spec, seeds[: args.control_seeds], control=True)
    summary["control"] = {n: min(r[n] for r in ctrl) for n in numbers}
    for name in faults.NAMES if args.faults else ():
        with faults.plant(name):
            got = read(spec, seeds[: args.faults], control=False)
        summary[name] = {n: min(r[n] for r in got) for n in numbers}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
