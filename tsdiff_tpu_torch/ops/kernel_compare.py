"""The kernels of several checkouts of this repository side by side, on the card:

    python -m tsdiff_tpu_torch.ops.kernel_compare [--train] PARENT . . PARENT

Runs phases 1-3 of each checkout's own ``chip_smoke.py`` (card, build, every
kernel against its plain version), one process per checkout, in the order
given: parent, change, change, parent spreads the card's drift over both.
With ``--train`` each process also runs that checkout's phase 6 (the train
CLI, then the ms per step on one fixed batch and a profiled step, all in its
log; where it has them, the packed training runs too) and adds the ms per
train step to the table.
Every kernel is timed the same way in every checkout, as the median of five
timings of 20 launches (CUDA events after two warm-up launches), also where
that checkout's ``chip_smoke.py`` timed it otherwise.  Each run's log goes to
``chiprun_out/kernel_compare_<i>.txt``; the table at the end gives per kernel
and run the median ms and the max abs error against the plain version.  A
checkout made with ``git archive`` needs ``artifacts/`` (the trained
checkpoints); a link to this checkout's will do.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

_MARK = "KERNEL_COMPARE "

# Runs in a fresh interpreter inside the checkout, so that its own
# chip_smoke.py and tsdiff_tpu_torch are the ones imported.
_CHILD = r'''
import json, os, sys
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import chip_smoke as m


def median_ms(fn, iters=20, warmup=2, repeats=5):
    for _ in range(warmup):
        fn()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ts = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        torch.cuda.synchronize()
        ts.append(s.elapsed_time(e) / iters)
    return float(np.median(ts)), float(min(ts))


# chip_smoke.py before the timing repair took one mean of `iters` launches
if getattr(m, "TIMING_ITERS", None) is None:
    m.cuda_time_ms = lambda fn, iters, warmup=2: median_ms(fn)[0]
if not torch.cuda.is_available():
    m.fail("CUDA is not available")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
m.phase_card()
m.phase_build()
rows = {}
for key, v in m.phase_kernels().items():
    name = "B5 packed_score_int8" if key[0] == "int8" else "B1 packed_score"
    rows[f"{name} N={key[-2]} {key[-1]}"] = v
for (n, dn), v in m.phase_dense_kernels().items():
    rows[f"B2 condensed_score N={n} {dn}"] = v
names = {"fwd": "B3 forward", "bwd": "B3 backward", "stack": "B4",
         "xty": "B3 backward's weight gradients alone"}
for (n, dn), parts in m.phase_stack_kernels().items():
    for part, v in parts.items():
        if part in names:  # not the backward's profiled split
            rows[f"{names[part]} N={n} {dn}"] = v
# CUDA events in every checkout, also where chip_smoke.py keeps a profiled time
rows = {k: {"ms": v.get("ms_events", v["ms"]), "max_abs_err": v["max_abs_err"]}
        for k, v in rows.items()}
if "--train" in sys.argv:
    if hasattr(m, "train_setup"):   # chip_smoke.py with the packed training phase
        setup = m.train_setup()
        tr = m.phase_train(setup)
        packed = m.phase_train_packed(setup)
        rows["packed train step, fixed N=24 batch"] = {"ms": packed["ms_per_step"],
                                                      "max_abs_err": None}
    else:
        tr = m.phase_train()
    rows["train step, fixed N=24 batch"] = {"ms": tr["ms_per_step"], "max_abs_err": None}
print("''' + _MARK + r'''" + json.dumps(rows))
'''


def run(checkout: str, log_path: str, flags: list[str]) -> dict:
    """The kernels' ``{name: {"ms", "max_abs_err"}}`` of one checkout."""
    with open(log_path, "w") as log:
        proc = subprocess.run([sys.executable, "-c", _CHILD, *flags], cwd=checkout,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.write(proc.stdout)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(_MARK)]
    if proc.returncode != 0 or not lines:
        sys.exit(f"{checkout}: phases 1-3 failed (exit {proc.returncode}); see {log_path}")
    return json.loads(lines[-1][len(_MARK):])


def main(argv: list[str]) -> None:
    flags = [a for a in argv if a == "--train"]
    argv = [a for a in argv if a != "--train"]
    if not argv:
        sys.exit(__doc__)
    os.makedirs("chiprun_out", exist_ok=True)
    runs = []
    for i, checkout in enumerate(argv):
        runs.append(run(os.path.abspath(checkout), os.path.join("chiprun_out",
                                                                f"kernel_compare_{i}.txt"), flags))
        print(f"run {i}: {checkout} done", flush=True)
    print("kernel | " + " | ".join(f"run {i} ({c}) ms, max abs err" for i, c in enumerate(argv)))
    for name in dict.fromkeys(name for r in runs for name in r):   # every run's, in order
        print(f"{name} | " + " | ".join(
            f"{r[name]['ms']:.4f}, " + ("-" if r[name]["max_abs_err"] is None
                                       else f"{r[name]['max_abs_err']:.6g}")
            if name in r else "-" for r in runs))


if __name__ == "__main__":
    main(sys.argv[1:])
